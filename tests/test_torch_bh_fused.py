"""The port's fused Barnes-Hut path (nbody_tpu_torch/ops/bh_fused.py) on the
CPU, where K6's wrapper takes its plain version, held against
tests/oracle.py and against the JAX package's fused kernel.

The JAX kernel runs once, in Pallas interpret mode, in a module-scoped
fixture, at one group per program: its interpreted body is traced once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core import capacity as jcap
from nbody_tpu.ops import barneshut as jb
from nbody_tpu.ops import bh_fused as jf
from nbody_tpu.ops import bh_grid as jg
from nbody_tpu.ops import morton as jm
from nbody_tpu_torch.core import capacity
from nbody_tpu_torch.ops import bh_fused as tf
from nbody_tpu_torch.ops.barneshut import CapacityError
from nbody_tpu_torch.utils.fixtures import plummer_cloud
from tests.oracle import accel_exhaustive_f64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EPS2, G, THETA = 0.01, 1.0, 0.5
K1_ATOL, K1_RTOL = 2e-5, 2e-4  # the f32 kernel bound (test_pallas.py:25)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _jax_fixture(name):
    """The four fixtures of tests/test_bh_fused.py: (pos, mass, group_size)."""
    if name == "uniform_parity":
        rng = np.random.default_rng(3)
        return rng.uniform(-1, 1, (384, 3)), rng.uniform(0.1, 1.0, 384), 128
    if name == "clustered_exact":
        rng = np.random.default_rng(7)
        core = rng.normal(0, 1e-4, (300, 3))
        outliers = rng.uniform(-1, 1, (20, 3)) * 50.0
        return np.vstack([core, outliers]), rng.uniform(0.1, 1.0, 320), 128
    if name == "plummer":
        arr = plummer_cloud(700, seed=9)
        return arr[:, :3], arr[:, 6], 128
    # two_groups_and_padding: partial groups and pad slots, the case the JAX
    # test can no longer reach (its burst_rows=4 trips bh_fused.py:858)
    rng = np.random.default_rng(11)
    return rng.uniform(-1, 1, (300, 3)), rng.uniform(0.1, 1.0, 300), 128


@pytest.mark.parametrize("name", ["uniform_parity", "clustered_exact", "plummer",
                                  "two_groups_and_padding"])
def test_fused_plain_within_oracle_bound(name):
    """(a) The port's whole pipeline, plain version, within the JAX tests'
    0.02 of fp64 direct summation (test_bh_fused.py:51)."""
    pos, mass, b = _jax_fixture(name)
    before = (tf.fused_group_forces.launches, tf.fused_group_forces.evaluations)
    acc, stats = tf.barneshut_fused(_t(pos), _t(mass), G=G, softening_sq=EPS2,
                                    theta=THETA, group_size=b, return_stats=True)
    # CPU: no kernel launch, no evaluation counted
    assert (tf.fused_group_forces.launches, tf.fused_group_forces.evaluations) == before
    assert int(stats["frontier_overflow"]) == 0
    assert int(stats["trimmed_groups"]) == 0
    assert acc.dtype == torch.float32 and acc.shape == (len(pos), 3)
    want = accel_exhaustive_f64(np.float32(pos), np.float32(mass), G=G)
    err = np.abs(acc.numpy() - want).max() / np.abs(want).max()
    assert err < 0.02, err
    assert int(stats["near_bodies"]) > 0
    assert int(stats["staged_sources"]) == int(stats["near_bodies"]) + int(
        stats["far_children"])
    if name == "two_groups_and_padding":
        fi = tf.prepare_fused(_t(pos), _t(mass), group_size=b)
        live = fi.gcount[fi.gcount > 0]
        assert len(live) >= 3 and int((live < b).sum()) >= 1  # a partial group
        assert int((fi.gcount == 0).sum()) > 0  # and empty slots


def test_fused_plain_f64():
    """f64 bodies take f64 tables and MAC: the plain path on its own."""
    pos, mass, b = _jax_fixture("uniform_parity")
    acc = tf.barneshut_fused(_t(pos, torch.float64), _t(mass, torch.float64),
                             G=G, softening_sq=EPS2, theta=THETA, group_size=b,
                             group_forces=tf.fused_group_forces_reference)
    assert acc.dtype == torch.float64
    want = accel_exhaustive_f64(pos, mass, G=G)
    assert np.abs(acc.numpy() - want).max() / np.abs(want).max() < 0.02


# (b) one fixture that accepts far cells: n=1000 uniform in +-2, B=64,
# ld=3, leaf_cap=8 (far_children ~3.8k, pops ~1k)
N_B, B_B, LD_B, LC_B = 1000, 64, 3, 8


@pytest.fixture(scope="module")
def jax_run():
    """The JAX kernel's forces and stats for these bodies, and the JAX-built
    tables and groups it used: the plain XLA steps of
    nbody_tpu/ops/bh_fused.py:1272-1327 and :1350-1363, with one
    interpret-mode fused_group_forces call over the occupied group slots
    at one group per program (JAX's default of 8 unrolls the interpreted
    body 8 times; programs per group are TPU mechanics, the same kernel)."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(-2, 2, (N_B, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 1, N_B).astype(np.float32)
    kw = dict(G=G, softening_sq=EPS2, theta=THETA, group_size=B_B, ld=LD_B,
              leaf_cap=LC_B)

    perm, keys, border = jm.morton_sort(jnp.asarray(pos), 10)
    pos_s = jnp.asarray(pos)[perm]
    gm_s = (jnp.asarray(G, jnp.float32) * jnp.asarray(mass)[perm]).astype(jnp.float32)
    keys_s = keys[perm]
    tree = jg.build_grid(pos_s, gm_s, keys_s, 10, LD_B)
    groups = jb.group_bodies(keys_s, N_B, 10, B_B, jf.auto_split_level(N_B, B_B))
    keep = jcap.auto_keep(N_B, B_B, groups[0].shape[0], jcap.budget_bytes())
    gstart, gcount, gidx, gvalid, trimmed = jb.compact_groups(*groups, keep)
    bsq = (border.astype(jnp.float32) / jnp.exp2(jnp.arange(16, dtype=jnp.float32))) ** 2

    live = np.flatnonzero(np.asarray(gcount) > 0)
    pg = jnp.concatenate([jnp.transpose(pos_s[gidx[live]], (0, 2, 1)),
                          jnp.zeros((len(live), 1, B_B), jnp.float32)], axis=1)
    ps = jnp.concatenate([pos_s.T, gm_s[None, :]], axis=0)
    ps = jnp.pad(ps, ((0, 0), (0, -(-N_B // 128) * 128 - N_B)))
    ft, it = jf.pack_tables(tree, LD_B)
    acc_g, jstats = jf.fused_group_forces(
        gcount[live], pg, ft, it, ps, bsq, jf.aux_octet_offsets(), theta=THETA,
        eps2=EPS2, leaf_cap=LC_B, ld=LD_B, frontier_cap=jf.FRONTIER_CAP,
        interpret=True, groups_per_program=1)
    dest = np.where(np.asarray(gvalid[live]),
                    np.asarray(perm)[np.clip(np.asarray(gidx[live]), 0, N_B - 1)], N_B)
    acc = np.zeros((N_B + 1, 3), np.float32)
    acc[dest.reshape(-1)] = np.transpose(np.asarray(acc_g), (0, 2, 1)).reshape(-1, 3)
    js = np.asarray(jstats).astype(np.float64)
    stats = {"pops": js[:, jf.S_POPS].sum(), "near_bodies": js[:, jf.S_NEAR].sum(),
             "far_children": js[:, jf.S_FAR].sum(),
             "frontier_overflow": js[:, jf.S_OVF].max()}
    return dict(
        pos=pos, mass=mass, kw=kw, acc=acc[:N_B], stats=stats,
        perm=np.asarray(perm), pos_s=np.asarray(pos_s), gm_s=np.asarray(gm_s),
        tree={k: np.asarray(v) for k, v in tree._asdict().items()},
        gstart=np.asarray(gstart), gcount=np.asarray(gcount),
        trimmed=int(trimmed), bsq=np.asarray(bsq),
    )


STAT_KEYS = ("pops", "near_bodies", "far_children", "frontier_overflow")


def _assert_k1_bound(got, want):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=K1_ATOL * scale, rtol=K1_RTOL)


def test_plain_traversal_on_jax_tables(jax_run):
    """(b1) The JAX-built tables and groups, carried across, through the
    port's plain traversal: the same stats, forces within K1's bound."""
    r = jax_run
    assert r["stats"]["far_children"] > 0 and r["trimmed"] == 0
    tree, gstart, gcount = tf.state_from_numpy(r["tree"], r["gstart"], r["gcount"])
    src = torch.cat([_t(r["pos_s"]), _t(r["gm_s"])[:, None]], dim=1)
    acc_s, stats = tf.fused_group_forces_reference(
        tree, gstart, gcount, src, _t(r["bsq"]), theta=THETA, eps2=EPS2,
        leaf_cap=LC_B, ld=LD_B, group_size=B_B)
    got = tf.summarize_stats(stats, torch.tensor(r["trimmed"]))
    for k in STAT_KEYS:
        assert float(got[k]) == r["stats"][k], k
    acc = tf.scatter_back(acc_s, torch.as_tensor(np.array(r["perm"])).long())
    _assert_k1_bound(acc.numpy(), r["acc"])


def test_whole_pipeline_against_jax(jax_run):
    """(b2) The port's whole pipeline on the same bodies.  Keys and
    permutation are equal and the tables agree to f32 rounding, so no MAC
    decision sits within rounding of its threshold here: the stats are
    equal, and the forces within K1's bound (the same sources, summed in
    another order)."""
    r = jax_run
    acc, stats = tf.barneshut_fused(_t(r["pos"]), _t(r["mass"]),
                                    return_stats=True, **r["kw"])
    for k in STAT_KEYS:
        assert float(stats[k]) == r["stats"][k], k
    assert int(stats["trimmed_groups"]) == 0
    _assert_k1_bound(acc.numpy(), r["acc"])
    want = accel_exhaustive_f64(r["pos"], r["mass"], G=G)
    assert np.abs(acc.numpy() - want).max() / np.abs(want).max() < 0.02


def test_state_from_numpy_types(jax_run):
    tree, gstart, gcount = tf.state_from_numpy(jax_run["tree"], jax_run["gstart"],
                                               jax_run["gcount"])
    assert tree.total == tf.grid_offsets(LD_B)[LD_B + 1]
    assert tree.cx.dtype == torch.float32 and tree.cnt.dtype == torch.int32
    assert gstart.dtype == gcount.dtype == torch.int32
    assert int(gcount.sum()) == N_B


def test_heavy_first_orders_slots_by_pairs():
    """K6's launch order: slots by staged sources x bodies, heaviest first,
    ties (and empty slots) in slot order."""
    stats = torch.zeros((5, tf.N_STATS), dtype=torch.int32)
    stats[:, tf.S_SRC] = torch.tensor([10, 300, 0, 40, 75], dtype=torch.int32)
    gcount = torch.tensor([30, 1, 0, 75, 40], dtype=torch.int32)
    order = tf.heavy_first(stats, gcount)
    assert order.dtype == torch.int32
    assert order.tolist() == [3, 4, 0, 1, 2]  # work 3000, 3000, 300, 300, 0


def _pieces(table):
    """The used rows of a df piece table, as (slot, first, end) tuples."""
    return [tuple(r) for r in table.tolist() if r[2] > r[1]]


def test_df_pieces_base_in_slot_order():
    """K6 df's base pieces: each occupied group cut evenly into whole warps,
    at most 256 bodies a piece, in slot order; empty groups get none; the
    table has G x ceil(B / 256) rows, the rest spare."""
    gcount = torch.tensor([1024, 0, 300, 37, 256], dtype=torch.int32)
    table = tf.df_pieces(gcount, 1024)
    assert table.dtype == torch.int32 and table.shape == (20, 3)
    assert _pieces(table) == [(0, 0, 256), (0, 256, 512), (0, 512, 768), (0, 768, 1024),
                              (2, 0, 160), (2, 160, 300), (3, 0, 37), (4, 0, 256)]
    assert all(r[2] <= r[1] for r in table.tolist()[8:])


def test_df_pieces_heavy_first():
    """Priced pieces: heaviest first (staged sources x the piece's bodies,
    ties in slot order), a 300-body group's two pieces apart by their
    bodies; the pieces still cover each group once."""
    gcount = torch.tensor([128, 300, 0, 64], dtype=torch.int32)
    stats = torch.zeros((4, tf.N_STATS), dtype=torch.int32)
    stats[:, tf.S_SRC] = torch.tensor([1000, 10, 0, 20], dtype=torch.int32)
    assert _pieces(tf.df_pieces(gcount, 512, stats)) == [
        (0, 0, 128), (1, 0, 160), (1, 160, 300), (3, 0, 64)]  # 128000, 1600, 1400, 1280


@pytest.mark.parametrize("seed,priced", [(0, False), (1, True), (2, True)])
def test_df_pieces_fit_their_table(seed, priced):
    """On random groups (and prices) every group is covered exactly once by
    pieces of whole warps (the last one ragged), at most 256 bodies each,
    and the pieces fit the table's fixed number of rows; the pricing
    pass's table is each group's first piece."""
    rng = np.random.default_rng(seed)
    gcount = torch.as_tensor(rng.integers(0, 1025, 300), dtype=torch.int32)
    stats = torch.zeros((300, tf.N_STATS), dtype=torch.int32)
    stats[:, tf.S_SRC] = torch.as_tensor(rng.pareto(1.0, 300) * 1000, dtype=torch.int32)
    table = tf.df_pieces(gcount, 1024, stats if priced else None)
    assert table.shape == (300 * 4, 3)
    used = _pieces(table)
    assert len(used) < table.shape[0]
    covered = np.zeros(300, np.int64)
    for g, b0, b1 in used:
        assert b0 % 32 == 0 and b1 - b0 <= tf.DF_THREADS
        assert b1 % 32 == 0 or b1 == int(gcount[g])
        covered[g] += b1 - b0
    assert (covered == gcount.numpy()).all()
    if priced:
        work = [int(stats[g, tf.S_SRC]) * (b1 - b0) for g, b0, b1 in used]
        assert work == sorted(work, reverse=True)
    pricing = tf.df_pricing_pieces(gcount)
    assert pricing.tolist() == [[g, 0, min(int(c), 256)] for g, c in enumerate(gcount)]


def test_fused_stages_pair_counts():
    """The stage profiler's pair counts: real pairs are staged sources x
    bodies; a live warp issues 64 body slots, a whole block the warps of
    the group size (here 100 bodies: two warps, 128 slots)."""
    from nbody_tpu_torch.diag import fused_stages

    stats = torch.zeros((3, tf.N_STATS), dtype=torch.int32)
    stats[:, tf.S_SRC] = torch.tensor([10, 20, 5], dtype=torch.int32)
    gcount = torch.tensor([100, 1, 0], dtype=torch.int32)
    real, live, whole = fused_stages.pair_counts(stats, gcount, 100)
    assert (real, live, whole) == (1020.0, 10 * 128 + 20 * 64, 35 * 128)


def test_fused_stages_profiler_needs_a_card(monkeypatch, capsys):
    """The stage profiler times the card and nothing else: with no card it
    exits 1 and says why."""
    from nbody_tpu_torch.diag import fused_stages

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fused_stages.main(["1000", "--robust"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("tool,argv", [("fused_stages", ["1000", "--df"]),
                                       ("fp64_kernels", [])])
def test_df_profilers_need_a_card(monkeypatch, capsys, tool, argv):
    """The df mode's profilers time the card and nothing else: with no
    card they exit 1 and say why."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert importlib.import_module(f"nbody_tpu_torch.diag.{tool}").main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err


def _overflow_bodies():
    rng = np.random.default_rng(21)
    return _t(rng.uniform(-2, 2, (2000, 3))), _t(rng.uniform(0.1, 1, 2000))


def test_check_fused_frontier_overflow_prescribes_cap():
    """(c) A frontier wider than the cap raises with the cap that fits."""
    pos, mass = _overflow_bodies()
    kw = dict(G=G, softening_sq=EPS2, theta=THETA, group_size=64, ld=4, leaf_cap=1)
    with pytest.raises(CapacityError, match="--bh-frontier-cap") as e:
        tf.check_fused(pos, mass, frontier_cap=128, **kw)
    need = int(str(e.value).split("--bh-frontier-cap ")[1].split()[0].rstrip(";"))
    assert need % 128 == 0 and need >= tf.FRONTIER_CAP
    stats = tf.check_fused(pos, mass, frontier_cap=need, **kw)
    assert int(stats["frontier_overflow"]) == 0


def test_check_fused_trimmed_groups_prescribes_keep():
    """(c) Too few group slots: occupied groups are trimmed and the message
    names the --bh-keep-groups value that fits."""
    pos, mass = _overflow_bodies()
    kw = dict(G=G, softening_sq=EPS2, theta=THETA, group_size=64)
    with pytest.raises(CapacityError, match="occupied groups trimmed") as e:
        tf.check_fused(pos, mass, keep_groups=4, **kw)
    keep = int(str(e.value).split("--bh-keep-groups ")[1].split()[0])
    assert int(tf.check_fused(pos, mass, keep_groups=keep, **kw)["trimmed_groups"]) == 0


PROBE_CASES = {"fits": dict(ld=4, leaf_cap=8),
               "overflow": dict(ld=4, leaf_cap=1, frontier_cap=128),
               "trimmed": dict(keep_groups=4)}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
@pytest.mark.parametrize("robust", [False, True], ids=["plain", "robust"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "df"])
def test_check_fused_reads_a_full_evaluations_stats(case, robust, dtype):
    """The probe's stats, from the evaluator's pricing pass alone, are a
    full evaluation's on the same bodies: key by key where they fit, and
    where the frontier overflows or groups are trimmed, the numbers its
    prescription names."""
    from nbody_tpu_torch.ops import bh_fused_df
    from nbody_tpu_torch.ops.cuda_exhaustive import rect_accelerations_reference

    pos, mass = (a.to(dtype) for a in _overflow_bodies())
    kw = dict(G=G, softening_sq=EPS2, theta=THETA, group_size=64, **PROBE_CASES[case],
              group_forces=(tf.fused_group_forces if dtype == torch.float32
                            else bh_fused_df.fused_group_forces_df))
    if robust:
        kw.update(outlier_slots=16, rect_forces=rect_accelerations_reference)
    full = (tf.barneshut_fused_robust if robust else tf.barneshut_fused)
    _, want = full(pos, mass, return_stats=True, **kw)
    fovf, trimmed = int(want["frontier_overflow"]), int(want["trimmed_groups"])
    assert (fovf > 0, trimmed > 0) == (case == "overflow", case == "trimmed")
    if case == "fits":
        got = tf.check_fused(pos, mass, robust=robust, **kw)
        assert got.keys() == want.keys()
        assert all(int(got[k]) == int(want[k]) for k in want)
        return
    with pytest.raises(CapacityError) as e:
        tf.check_fused(pos, mass, robust=robust, **kw)
    assert (f">= {fovf} octets" if fovf else f"{trimmed} occupied groups") in str(e.value)


@pytest.mark.parametrize("robust", [False, True], ids=["plain", "robust"])
def test_check_fused_prices_and_evaluates_nothing(monkeypatch, robust):
    """The probe calls the plain version at the "pops" cut only, runs no
    outlier rectangle, and under ``bh.probe`` records ``bh.k6.price`` and
    neither ``bh.k6.full`` nor ``bh.scatter``."""
    import collections

    from nbody_tpu_torch.diag import timing

    plain, cuts = tf.fused_group_forces_reference, []

    def spy(*args, **kw):
        cuts.append(kw["debug_mode"])
        return plain(*args, **kw)

    def no_rect(*args, **kw):
        raise AssertionError("the probe ran the outliers' rectangle")

    monkeypatch.setattr(tf, "fused_group_forces_reference", spy)
    pos, mass = _overflow_bodies()
    timing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tf.check_fused(pos[:600], mass[:600], robust=robust, group_size=64,
                       rect_forces=no_rect)
    spans = timing.RECORDER.spans()
    timing.clear()
    assert cuts == ["pops"]
    (root,) = [s for s in spans if s[1] == "bh.probe"]
    assert collections.Counter(s[1] for s in spans if s is not root) == {
        "bh.sort": 1, "bh.grid": 1, "bh.groups": 1, "bh.k6.price": 1,
        "host_sync.probe.stats": 1}


def test_capacity_budget(monkeypatch):
    monkeypatch.delenv("NBODY_HBM_BYTES", raising=False)
    assert capacity.budget_bytes(torch.device("cpu")) is None
    capacity.ensure_fits({"total": 10**15}, "x", budget=None)  # CPU: no-op
    monkeypatch.setenv("NBODY_HBM_BYTES", str(2**30))
    assert capacity.budget_bytes() == int(2**30 * capacity.BUDGET_FRAC)
    est = capacity.estimate_fused_bytes(10_000_000, 1024, 20_000, 6)
    with pytest.raises(CapacityError, match="NBODY_HBM_BYTES"):
        capacity.ensure_fits(est, "fused Barnes-Hut at n=10000000")
    # a tight budget clamps the slot margin toward its floor, never below
    n, b = 1_000_000, 1024
    assert capacity.auto_keep(n, b, 10**9, None) == 3 * (n // b) + 256
    assert capacity.auto_keep(n, b, 10**9, 1000) == capacity.occupied_groups_floor(n, b)
