"""The port's fp64 paths on the CPU, where the kernel wrappers take their
plain versions, held against the fp64 oracle and the JAX package:

* K4 (``ops/cuda_fp64.py``, fp64 all-pairs) against
  ``tests/oracle.py::accel_exhaustive_f64``, JAX's
  f64 ``rect_accelerations`` and, once, JAX's ``pallas_accelerations_df``
  in interpret mode, at the 1e-12 of tests/test_pallas_df.py;
* K5 (fp64 potential energy) against the PE formula of
  tests/test_pallas_df.py:88-101, at 1e-13;
* the fused Barnes-Hut path in f64 (``ops/bh_fused_df.py``) against an
  fp64 twin of JAX's df decision rule, restated from
  tests/test_bh_fused_df.py::twin_bh_f64 with the JAX package's jnp
  helpers (no interpret-mode kernel);
* the CLI with ``--dtype f64`` on the CPU, for both algorithms.

The kernels themselves run under the CPU emulation
(test_torch_kernel_emulation.py) and on the card (test_torch_cuda.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from conftest import DATA_DIR, random_cloud
from nbody_tpu.ops import exhaustive as jax_exh
from nbody_tpu.ops.barneshut import compact_groups, group_bodies
from nbody_tpu.ops.bh_fused import auto_ld, auto_split_level
from nbody_tpu.ops.bh_grid import build_grid, grid_offsets
from nbody_tpu.ops.morton import morton_sort
from nbody_tpu.ops.pallas_df import pallas_accelerations_df
from nbody_tpu_torch.cli.main import main
from nbody_tpu_torch.core import capacity
from nbody_tpu_torch.core.types import Bodies
from nbody_tpu_torch.io.csv import read_bodies, read_trajectory
from nbody_tpu_torch.ops import bh_fused, bh_fused_df, cuda_fp64, morton
from nbody_tpu_torch.utils.fixtures import write_fixture


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EPS2, THETA, LEAF_CAP = 0.01, 0.5, 64
F64 = torch.float64


def _t(a, dtype=F64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# ---- K4: fp64 all-pairs -------------------------------------------------


@pytest.mark.parametrize("rows", [slice(None), slice(100, 260)], ids=["square", "rect"])
def test_k4_plain_matches_oracle_and_jax(rows):
    arr = random_cloud(320, seed=3)
    pos, mass = arr[:, :3], arr[:, 6]
    before = cuda_fp64.cuda_rect_accelerations_f64.launches
    got = cuda_fp64.cuda_rect_accelerations_f64(_t(pos[rows]), _t(pos), _t(mass),
                                                G=0.7).numpy()
    assert cuda_fp64.cuda_rect_accelerations_f64.launches == before  # CPU: no kernel
    assert _rel(got, oracle.accel_exhaustive_f64(pos, mass, G=0.7)[rows]) < 1e-12
    jax_rect = jax_exh.rect_accelerations(jnp.asarray(pos[rows]), jnp.asarray(pos),
                                          jnp.asarray(mass), G=0.7)
    assert _rel(got, np.asarray(jax_rect)) < 1e-12


def test_k4_plain_matches_jax_df_kernel():
    """The one interpret-mode JAX call of this file: the TPU's double-float
    kernel K4 at a small size."""
    arr = random_cloud(200, seed=200)
    want = np.asarray(pallas_accelerations_df(jnp.asarray(arr[:, :3]),
                                              jnp.asarray(arr[:, 6]), interpret=True))
    got = cuda_fp64.cuda_accelerations_f64(_t(arr[:, :3]), _t(arr[:, 6])).numpy()
    assert _rel(got, want) < 1e-12


def test_k4_plain_self_term_zero():
    """Two coincident bodies feel nothing and stay finite (softening), as
    tests/test_pallas_df.py:104-115."""
    got = cuda_fp64.cuda_accelerations_f64(torch.zeros((2, 3), dtype=F64),
                                           torch.ones(2, dtype=F64))
    assert torch.isfinite(got).all() and torch.equal(got, torch.zeros_like(got))


def test_fp64_wrappers_refuse_what_the_kernels_cannot_take():
    pos32, mass32 = torch.zeros((4, 3)), torch.ones(4)
    with pytest.raises(TypeError, match="float64"):
        cuda_fp64.cuda_accelerations_f64(pos32, mass32)
    with pytest.raises(TypeError, match="float64"):
        cuda_fp64.cuda_potential_energy_f64(pos32, mass32)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no fp64 all-pairs kernel"):
        cuda_fp64.cuda_accelerations_f64(torch.zeros((4, 3), dtype=F64, device=meta),
                                         torch.ones(4, dtype=F64, device=meta))


# ---- K5: fp64 potential energy --------------------------------------------


def test_k5_plain_matches_pe_formula():
    rng = np.random.default_rng(11)
    pos, mass = rng.uniform(-2, 2, (300, 3)), rng.uniform(0.04, 1.0, 300)
    pos[1] = pos[0]  # a coincident pair: the r = 0 guard
    d = pos[None, :, :] - pos[:, None, :]
    r = np.sqrt((d * d).sum(-1))
    inv = np.where(r > 0, 1.0 / np.where(r > 0, r, 1.0), 0.0)
    want = -0.5 * 0.7 * (mass[:, None] * mass[None, :] * inv).sum()
    before = cuda_fp64.cuda_potential_energy_f64.launches
    got = cuda_fp64.cuda_potential_energy_f64(_t(pos), _t(mass), G=0.7)
    assert cuda_fp64.cuda_potential_energy_f64.launches == before
    assert got.dtype == F64 and abs(got.item() - want) / abs(want) < 1e-13


# ---- K6 df: the fused Barnes-Hut path in fp64 -----------------------------


def twin_df(pos, mass, *, group_size, ld=0, leaf_cap=LEAF_CAP, mac=np.float32):
    """fp64 twin of the df fused path, restated from
    tests/test_bh_fused_df.py::twin_bh_f64 (same JAX helpers for the sort,
    grid and groups; fp64 physics) to also return the far cells and near
    bodies it counts.  `mac` is the MAC's type: np.float32 is JAX's df rule
    (the f32 hi halves); np.float64 classifies on the f64 values instead."""
    n = pos.shape[0]
    depth = 10
    ld = ld or auto_ld(n)
    pos64 = jnp.asarray(pos, jnp.float64)
    perm, keys, border = morton_sort(pos64, depth)
    pos_s = np.asarray(pos64[perm], np.float64)
    gm_s = np.asarray(mass, np.float64)[np.asarray(perm)]
    tree = build_grid(pos64[perm], jnp.asarray(gm_s), keys[perm], depth, ld,
                      table_dtype=jnp.float64)
    groups = group_bodies(keys[perm], n, depth, group_size,
                          auto_split_level(n, group_size))
    _, gcount, group_idx, group_valid, trimmed = compact_groups(
        *groups, groups[0].shape[0])
    assert int(trimmed) == 0
    gcount, group_idx, group_valid = map(np.asarray, (gcount, group_idx, group_valid))

    off = grid_offsets(ld)
    com64 = [np.asarray(getattr(tree, f)[0], np.float64) for f in ("cx", "cy", "cz")]
    gm64 = np.asarray(tree.gm[0], np.float64)
    cnt, start = np.asarray(tree.cnt[0]), np.asarray(tree.start[0])
    com = [c.astype(mac) for c in com64]
    bsq = (mac(np.asarray(border)) / np.exp2(np.arange(16)).astype(mac)) ** 2
    theta_sq = mac(THETA * THETA)
    body = pos_s.astype(mac)

    acc_s = np.zeros((n, 3))
    n_far = n_near = 0
    for g in np.nonzero(gcount)[0]:
        members = group_idx[g][group_valid[g]]
        lo, hi = body[members].min(axis=0), body[members].max(axis=0)
        far_cells, near_runs = [], []
        frontier = np.arange(8)  # level-1 cells
        for lvl in range(1, ld + 1):
            flat = off[lvl] + frontier
            dd = [c[flat] - np.clip(c[flat], lo[k], hi[k]) for k, c in enumerate(com)]
            d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
            exists = cnt[flat] > 0
            far = exists & (theta_sq * d2 > bsq[lvl])
            near = exists & ~far & ((cnt[flat] <= leaf_cap) | (lvl == ld))
            far_cells += flat[far].tolist()
            near_runs += [(start[f], start[f] + cnt[f]) for f in flat[near]]
            opened = exists & ~far & ~near
            frontier = (8 * frontier[opened][:, None] + np.arange(8)).reshape(-1)
        n_far += len(far_cells)
        n_near += sum(e - s for s, e in near_runs)
        fc = np.asarray(far_cells, dtype=np.int64)
        src = np.concatenate([np.stack([c[fc] for c in com64], axis=1)]
                             + [pos_s[s:e] for s, e in near_runs])
        w = np.concatenate([gm64[fc]] + [gm_s[s:e] for s, e in near_runs])
        d = src[None, :, :] - pos_s[members][:, None, :]
        r2 = (d * d).sum(-1) + EPS2
        acc_s[members] = ((w * r2 ** -1.5)[..., None] * d).sum(1)
    acc = np.zeros((n, 3))
    acc[np.asarray(perm)] = acc_s
    return acc, n_far, n_near


def _port_df(pos, mass, **kw):
    before = bh_fused_df.fused_group_forces_df.launches
    acc, stats = bh_fused_df.barneshut_fused_df(
        _t(pos), _t(mass), G=1.0, softening_sq=EPS2, theta=THETA, return_stats=True,
        **kw)
    assert bh_fused_df.fused_group_forces_df.launches == before  # CPU: plain version
    assert acc.dtype == F64
    assert int(stats["frontier_overflow"]) == 0 and int(stats["trimmed_groups"]) == 0
    return acc.numpy(), int(stats["far_children"]), int(stats["near_bodies"])


def _df_fixture(name):
    """(pos, mass, knobs): the fixtures of tests/test_bh_fused_df.py:159-182,
    and one whose groups accept far cells (that of test_torch_bh_fused.py)."""
    if name == "uniform":
        rng = np.random.default_rng(5)
        return rng.uniform(-1, 1, (384, 3)), rng.uniform(0.1, 1.0, 384), {}
    if name == "clustered":
        rng = np.random.default_rng(11)
        pos = np.vstack([rng.normal(0, 1e-4, (280, 3)),
                         rng.uniform(-1, 1, (40, 3)) * 30.0])
        return pos, rng.uniform(0.1, 1.0, pos.shape[0]), {}
    rng = np.random.default_rng(5)
    return (rng.uniform(-2, 2, (1000, 3)), rng.uniform(0.1, 1, 1000),
            dict(group_size=64, ld=3, leaf_cap=8))


@pytest.mark.parametrize("name", ["uniform", "clustered", "far_cells"])
def test_df_plain_matches_jax_df_rule_twin(name):
    pos, mass, kw = _df_fixture(name)
    kw = {"group_size": 128, **kw}
    acc, n_far, n_near = _port_df(pos, mass, **kw)
    want, far_w, near_w = twin_df(pos, mass, **kw)
    assert (n_far, n_near) == (far_w, near_w)
    assert n_near > 0 and (n_far > 0 or name != "far_cells")
    assert _rel(acc, want) < 1e-12


def test_df_plain_takes_the_f32_mac_where_an_f64_mac_differs():
    """A fixture built so that one cell's MAC test lands on its threshold in
    f32 and 1e-12 past it in f64.  Group 0's box ends at x = -1; a level-2
    cell of two bodies has its centre of mass at x = 1 + 1e-12, so with
    border 4, theta 0.5 and bsq[2] = 1 the test is 0.25 * (2 + 1e-12)^2 > 1:
    true in f64 (far), false in f32 (near: the cell is terminal).  JAX's df
    kernel classifies in f32 (nbody_tpu/ops/bh_fused.py:256-259), so the
    port must too: before the repair its f64 plain path took the cell as a
    far centre of mass."""
    e = 1e-12
    pos = np.array([
        [-1.75, -1.75, -1.75], [-1.0, -1.25, -1.25], [-1.5, -1.5, -1.5],
        [-1.25, -1.6, -1.4],  # group 0: x in [-1.75, -1]
        [1.0 + e, -1.7, -1.5], [1.0 + e, -1.3, -1.5],  # one level-2 cell
        [2.0, 2.0, 2.0],  # sets border = 4
    ])
    mass = np.ones(len(pos))
    kw = dict(group_size=4, ld=2, leaf_cap=1)
    want, far_w, near_w = twin_df(pos, mass, **kw)
    want64, far64, near64 = twin_df(pos, mass, mac=np.float64, **kw)
    assert (far64, near64) != (far_w, near_w)  # the two rules disagree here
    assert _rel(want64, want) > 1e-6
    acc, n_far, n_near = _port_df(pos, mass, **kw)
    assert (n_far, n_near) == (far_w, near_w)
    assert _rel(acc, want) < 1e-12
    # barneshut_fused on f64 bodies takes the same rule
    plain = bh_fused.barneshut_fused(_t(pos), _t(mass), softening_sq=EPS2,
                                     group_forces=bh_fused.fused_group_forces_reference,
                                     **kw)
    assert _rel(plain.numpy(), want) < 1e-12


def test_df_entry_point_on_f32_bodies_computes_in_f64():
    """barneshut_fused_df casts to f64 first, as JAX's does
    (bh_fused_df.py:123): f32 bodies give the f64 bodies' answer, in f64."""
    arr = random_cloud(500, seed=8)
    pos64, mass64 = _t(arr[:, :3]), _t(arr[:, 6])
    got = bh_fused_df.barneshut_fused_df(pos64.float().double(), mass64.float().double(),
                                         group_size=64)
    got32 = bh_fused_df.barneshut_fused_df(pos64.float(), mass64.float(), group_size=64)
    assert got32.dtype == F64 and torch.equal(got, got32)


def test_df_capacity_estimate_is_doubled(monkeypatch):
    """f64 sources and tables carry twice the f32 bytes (bh_fused_df.py:
    146-149): a budget 1.5x the f32 estimate admits f32 and refuses f64."""
    n, b, ld, keep = 2000, 64, 3, 100
    keep = min(keep, morton.group_capacity(n, b, morton.auto_split_level(n, b)))
    est = capacity.estimate_fused_bytes(n, b, keep, ld)["total"]
    monkeypatch.setenv("NBODY_HBM_BYTES", str(int(1.5 * est / capacity.BUDGET_FRAC)))
    arr = random_cloud(n, seed=2)
    kw = dict(ld=ld, group_size=b, keep_groups=keep)
    bh_fused.prepare_fused(_t(arr[:, :3], torch.float32), _t(arr[:, 6], torch.float32),
                           **kw)
    with pytest.raises(capacity.CapacityError, match="fused Barnes-Hut"):
        bh_fused.prepare_fused(_t(arr[:, :3]), _t(arr[:, 6]), **kw)


# ---- the CLI in f64 on the CPU --------------------------------------------


def test_cli_f64_exhaustive_auto_backend(tmp_path, capsys):
    """--dtype f64 with the default backend on the CPU: the plain fp64 path,
    within the golden file's %lf resolution of the reference binary."""
    out = tmp_path / "o.csv"
    assert main([os.path.join(DATA_DIR, "10_bodies.csv"), "0", "10", "0.1", str(out),
                 "--device", "cpu", "--dtype", "f64", "--energy"]) == 0
    assert "backend: torch, dtype: f64, device: cpu" in capsys.readouterr().out
    golden = np.loadtxt(os.path.join(DATA_DIR, "golden_exh_10bodies_0_10_0.1.csv"),
                        delimiter=",")
    np.testing.assert_allclose(np.loadtxt(out, delimiter=","), golden, atol=1.1e-5,
                               rtol=0)


def test_cli_f64_barnes_hut_matches_df_call(tmp_path, capsys):
    """The CLI's f64 Barnes-Hut force is barneshut_fused_df with the flags'
    knobs: one step of a 2,000-body cloud against the same KDK step by
    hand."""
    arr = random_cloud(2000, seed=4)
    src, out = tmp_path / "in.csv", tmp_path / "o.csv"
    write_fixture(src, arr)
    assert main([str(src), "0", "0.01", "0.01", str(out), "--device", "cpu",
                 "--dtype", "f64", "--algo", "barnes-hut", "--bh-traversal", "fused",
                 "--bh-group-size", "64", "--bh-leaf-cap", "8", "--bh-ld", "3",
                 "--theta", "0.6"]) == 0
    assert "backend: torch/fused, dtype: f64" in capsys.readouterr().out
    b = Bodies.from_numpy(read_bodies(str(src)), dtype=F64)
    acc = bh_fused_df.barneshut_fused_df(
        b.pos, b.mass, theta=0.6, group_size=64, leaf_cap=8, ld=3,
        group_forces=bh_fused_df.fused_group_forces_df_reference)
    dt = float(np.float32(0.01))
    pos = b.pos + (b.vel + acc * (dt * 0.5)) * dt
    rows, n = read_trajectory(out)
    np.testing.assert_allclose(rows.reshape(2, n, 5)[1, :, 1:4], pos.numpy(),
                               atol=1.1e-6, rtol=0)
