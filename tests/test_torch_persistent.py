"""The port's persistent Morton layout (nbody_tpu_torch/ops/bh_persistent.py)
on the CPU, where K6's and K1's wrappers take their plain versions: its
state, tables and forces against the JAX package's, and twins of
tests/test_bh_persistent.py held to the same bounds.

The JAX fused kernel runs once, in Pallas interpret mode, in a
module-scoped fixture, at one group per program.
"""

from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import bh_fused as jf
from nbody_tpu.ops import bh_grid as jg
from nbody_tpu.ops import bh_persistent as jp
from nbody_tpu_torch.ops import bh_grid as tg
from nbody_tpu_torch.ops import bh_persistent as tp
from nbody_tpu_torch.ops.barneshut import CapacityError
from nbody_tpu_torch.ops.bh_fused import S_FAR, S_NEAR, S_POPS
from tests.oracle import accel_exhaustive_f64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EPS2, G, THETA, B = 0.01, 1.0, 0.5, 128
K1_ATOL, K1_RTOL = 2e-5, 2e-4  # the f32 kernel bound (test_pallas.py:25)


def _cloud(n, seed=0):
    """tests/test_bh_persistent.py:30-35's fixture, as f32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, (n, 3)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
            rng.uniform(0.04, 1.0, n).astype(np.float32))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _slots(a, g):
    """A JAX planar (G, C, B) array as the port's (G·B, C) rows."""
    return np.asarray(a).transpose(0, 2, 1).reshape(g * B, -1)


# ---- against the JAX package -----------------------------------------------


def test_grid_from_terminal_matches_jax():
    """Ints exact, floats rtol 1e-6, on terminal accumulators with empty
    cells and ranges that leave gaps between cells.  The cloud sits off the
    origin, so every level sums terms of one sign and the two summation
    orders differ by a few f32 roundings."""
    ld, rng = 3, np.random.default_rng(4)
    k = 8**ld
    cnt = rng.integers(0, 4, k) * (rng.uniform(size=k) < 0.6)
    st = np.cumsum(cnt + rng.integers(0, 3, k)) - cnt
    en = st + cnt + rng.integers(0, 2, k) * (cnt > 0)
    st, en = np.where(cnt > 0, st, 2**31 - 1), np.where(cnt > 0, en, -1)
    gm = np.where(cnt > 0, rng.uniform(0.1, 1.0, k), 0.0).astype(np.float32)
    w = (gm[:, None] * rng.uniform(0.5, 1.5, (k, 3))).astype(np.float32)
    args = (w, gm, cnt.astype(np.int32), st.astype(np.int32), en.astype(np.int32))
    want = jg.grid_from_terminal(*[jnp.asarray(a) for a in args], ld)
    got = tg.grid_from_terminal(*_t(*args), ld)
    for name in ("cnt", "start"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)).reshape(-1))
    for name in ("cx", "cy", "cz", "gm"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)).reshape(-1), rtol=1e-6)


@pytest.mark.parametrize("robust_slots", [0, 128])
def test_init_state_equals_jax(robust_slots):
    """Over the occupied groups the layout rows, gcount, orig, valid and the
    cell ids are JAX's exactly; JAX's pack_it of the port's start and span
    is JAX's table; the outliers are the same set with the same G·m."""
    n = 480
    pos, vel, mass = _cloud(n, seed=1)
    js = jp.init_state(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), G=G,
                       group_size=B, robust_slots=robust_slots)
    ts = tp.init_state(*_t(pos, vel, mass), G=G, group_size=B, robust_slots=robust_slots)
    gc = np.asarray(js.gcount)
    g, occ = gc.shape[0], np.repeat(gc > 0, B)
    np.testing.assert_array_equal(ts.gcount.numpy()[:g], gc)
    assert int(ts.gcount[g:].sum()) == 0
    np.testing.assert_array_equal(ts.src.numpy()[:g * B][occ], _slots(js.pg, g)[occ])
    np.testing.assert_array_equal(ts.vel.numpy()[:g * B][occ], _slots(js.vel, g)[occ])
    for name in ("orig", "valid", "nid"):
        np.testing.assert_array_equal(getattr(ts, name).numpy()[:g * B][occ],
                                      np.asarray(getattr(js, name)).reshape(-1)[occ])
    ints = namedtuple("Ints", "start cnt")(ts.start.numpy()[None], ts.cnt.numpy()[None])
    np.testing.assert_array_equal(np.asarray(jf.pack_it(ints, ts.ld)), np.asarray(js.it))
    # the levels the kernel reads (XLA's exp2 on the CPU is off by an ulp
    # from level 13 on; torch's is exact)
    np.testing.assert_array_equal(ts.bsq.numpy()[:ts.ld + 1], np.asarray(js.bsq)[:ts.ld + 1])
    if robust_slots:
        assert set(ts.out_slots.tolist()) == set(np.asarray(js.out_slots).tolist())
        by_slot = dict(zip(np.asarray(js.out_slots).tolist(), np.asarray(js.out_gm).tolist()))
        assert [by_slot[s] for s in ts.out_slots.tolist()] == ts.out_gm.tolist()
    # the JAX state carried across is the port's
    st2 = tp.state_from_numpy(ld=ts.ld, **{k: getattr(js, k) for k in (
        "pg", "vel", "valid", "gcount", "orig", "nid", "it", "bsq", "border", "acc",
        "out_slots", "out_gm")})
    for name in ("start", "cnt", "real", "valid"):
        assert torch.equal(getattr(st2, name), getattr(ts, name)[:getattr(st2, name).shape[0]])


N_S, LD_S, LC_S, DT_S = 500, 3, 8, 1e-2  # far cells accepted: ~140 far children


@pytest.fixture(scope="module")
def drifted():
    """Both packages' states of one cloud after 3 drift-only steps (no
    resort: the partition is stale), and one interpret-mode JAX K6 call on
    the JAX state's occupied groups at one group per program."""
    pos, vel, mass = _cloud(N_S, seed=1)
    js = jp.init_state(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass), G=G,
                       group_size=B, ld=LD_S)
    ts = tp.init_state(*_t(pos, vel, mass), G=G, group_size=B, ld=LD_S)
    pg = js.pg
    for _ in range(3):
        pg = pg.at[:, :3, :].add(js.vel * jnp.float32(DT_S))
        ts.src[:, :3] += ts.vel * DT_S
    ft = jp._ft_from_state(pg, js.nid, LD_S)
    g = pg.shape[0]
    live = np.flatnonzero(np.asarray(js.gcount) > 0)
    ps = jnp.transpose(pg, (1, 0, 2)).reshape(4, g * B)
    acc, stats = jf.fused_group_forces(
        js.gcount[live], pg[live], ft, js.it, ps, js.bsq, jf.aux_octet_offsets(),
        theta=THETA, eps2=EPS2, leaf_cap=LC_S, ld=LD_S, interpret=True,
        groups_per_program=1)
    return dict(ts=ts, pg=np.asarray(pg), ft=np.asarray(ft), live=live,
                acc=np.asarray(acc).transpose(0, 2, 1).reshape(-1, 3),
                stats=np.asarray(stats))


def test_step_tables_match_jax(drifted):
    """The per-step float tables on the stale partition, packed as JAX's
    pack_ft: rtol 1e-5, atol 1e-6 (the summation orders differ)."""
    ts = drifted["ts"]
    g = drifted["pg"].shape[0]
    np.testing.assert_array_equal(ts.src.numpy()[:g * B], _slots(drifted["pg"], g))
    tree = tp._ft_from_state(ts)
    fl = namedtuple("Floats", "cx cy cz gm")(
        *[getattr(tree, k).numpy()[None] for k in ("cx", "cy", "cz", "gm")])
    np.testing.assert_allclose(np.asarray(jf.pack_ft(fl, LD_S)), drifted["ft"],
                               rtol=1e-5, atol=1e-6)


def test_state_forces_match_jax_kernel(drifted):
    """state_forces (K6's plain version on the CPU) against JAX's K6 on the
    same stale state: the f32 kernel bound on the real slots, and the pops,
    near and far stats lanes equal."""
    ts, live = drifted["ts"], drifted["live"]
    acc, stats = tp.state_forces(ts, theta=THETA, softening_sq=EPS2, leaf_cap=LC_S)
    real = (live[:, None] * B + np.arange(B)).reshape(-1)
    keep = ts.valid.numpy()[real]
    got, want = acc.numpy()[real][keep], drifted["acc"][keep]
    err, scale = np.abs(got - want), np.abs(want).max()
    assert (err <= K1_ATOL * scale + K1_RTOL * np.abs(want)).all(), err.max()
    st, js = stats.numpy()[live], drifted["stats"]
    for lane, jlane in ((S_POPS, jf.S_POPS), (S_NEAR, jf.S_NEAR), (S_FAR, jf.S_FAR)):
        np.testing.assert_array_equal(st[:, lane], js[:, jlane])
    assert st[:, S_FAR].sum() > 0
    assert not acc.numpy()[~ts.valid.numpy()].any()  # pads get no force


def test_cell_sums_fixed_point():
    """The rebuild's run sums against fp64 sums of the same f32 rows, to
    within a rounding to f32, with empty runs, one run of most rows, and a
    column of mixed signs, and a zero column; a rerun gives the same bits;
    a non-finite value makes its column NaN."""
    rng = np.random.default_rng(8)
    n, k = 5000, 300
    counts = rng.integers(0, 4, k)
    counts[17] = n - counts.sum() + counts[17]
    bounds = np.concatenate([[0], np.cumsum(counts)])
    vals = np.stack([rng.uniform(-3, 3, n), rng.uniform(0, 1e-6, n),
                     rng.normal(0, 1e3, n), np.zeros(n)], 1).astype(np.float32)
    got = tp._cell_sums(torch.as_tensor(vals), torch.as_tensor(bounds))
    want = np.stack([vals[a:b].astype(np.float64).sum(0) for a, b in
                     zip(bounds[:-1], bounds[1:])])
    np.testing.assert_allclose(got.numpy(), want, rtol=1.2e-7, atol=0)
    assert torch.equal(got, tp._cell_sums(torch.as_tensor(vals), torch.as_tensor(bounds)))
    vals[9, 2] = np.inf
    bad = tp._cell_sums(torch.as_tensor(vals), torch.as_tensor(bounds)).numpy()
    assert np.isnan(bad[:, 2]).all() and np.array_equal(bad[:, :2], got.numpy()[:, :2])


# ---- twins of tests/test_bh_persistent.py, port only -----------------------

_KW = dict(G=G, softening_sq=EPS2, group_size=B)


def test_state_roundtrip_and_initial_forces():
    """test_bh_persistent.py:50-65: emit gives the bodies back; the primed
    forces are within 0.02 of fp64 direct summation."""
    n = 500
    pos, vel, mass = _cloud(n, seed=1)
    st = tp.init_state(*_t(pos, vel, mass), G=G, group_size=B)
    p2, v2 = tp.emit(st)
    assert np.array_equal(p2.numpy(), pos) and np.array_equal(v2.numpy(), vel)
    st, stats = tp.prime(st, theta=THETA, softening_sq=EPS2, leaf_cap=64)
    acc = np.zeros((n, 3), np.float32)
    acc[st.orig[st.real].numpy()] = st.acc[st.real].numpy()
    want = accel_exhaustive_f64(pos, mass, G=G)
    assert np.abs(acc - want).max() / np.abs(want).max() < 0.02


def test_persistent_matches_per_step_resort():
    """test_bh_persistent.py:68-84: 4 unsorted steps against a resort every
    step, dp < 1e-5; the velocities too (emit routes only real slots, so
    pads, which K6 gives no force, never show)."""
    pos, vel, mass = _t(*_cloud(400, seed=3))
    p_a, v_a = tp.simulate_persistent(pos, vel, mass, 4, 1e-3, resort_every=4, **_KW)
    p_b, v_b = tp.simulate_persistent(pos, vel, mass, 4, 1e-3, resort_every=1, **_KW)
    assert (p_a - p_b).abs().max().item() < 1e-5
    assert (v_a - v_b).abs().max().item() < 1e-5


def test_persistent_matches_leapfrog_reference():
    """test_bh_persistent.py:87-106: against KDK with fp64 exact forces,
    dp < 5e-4."""
    pos, vel, mass = _cloud(400, seed=5)
    dt, steps = 1e-3, 3
    p_a, _ = tp.simulate_persistent(*_t(pos, vel, mass), steps, dt, resort_every=2, **_KW)
    p, v = pos.astype(np.float64), vel.astype(np.float64)
    a = accel_exhaustive_f64(p, mass, G=G)
    for _ in range(steps):
        v = v + a * (dt / 2)
        p = p + v * dt
        a = accel_exhaustive_f64(p, mass, G=G)
        v = v + a * (dt / 2)
    assert np.abs(p_a.numpy() - p).max() < 5e-4


def test_resort_preserves_bodies():
    """test_bh_persistent.py:109-121: a resort is a pure relabelling."""
    st = tp.init_state(*_t(*_cloud(300, seed=7)), G=G, group_size=B)
    st2 = tp.resort(st)
    for a, b in zip(tp.emit(st), tp.emit(st2)):
        assert torch.equal(a, b)
    assert int(st2.gcount.sum()) == 300


def test_persistent_long_run_energy_drift():
    """test_bh_persistent.py:124-140: 100 steps, resorts every 10, drift
    below 1e-3."""
    from nbody_tpu_torch.diag.energy import energy_drift, get_energy

    pos, vel, mass = _t(*_cloud(400, seed=21))
    vel = vel * 0.3
    ke0, pe0 = get_energy(pos, vel, mass, G=G)
    p1, v1 = tp.simulate_persistent(pos, vel, mass, 100, 1e-4, resort_every=10, **_KW)
    ke1, pe1 = get_energy(p1, v1, mass, G=G)
    assert abs(energy_drift(float(ke1 + pe1), float(ke0 + pe0))) < 1e-3


def test_drift_guard_forces_per_step_resort():
    """test_bh_persistent.py:143-160: a hot system trips the drift guard,
    and the run is bitwise the resort_every=1 run.  The JAX test's x100
    velocities move the fastest body 0.2 of a terminal cell in a 4-step
    chunk, under the guard's 0.25, so they do not trip it (its positions
    agree all the same); x1000 does, and the progress notes say so."""
    pos, vel, mass = _t(*_cloud(300, seed=31))
    vel = vel * 1000.0
    notes = []
    a = tp.simulate_persistent(pos, vel, mass, 4, 1e-3, resort_every=4, progress_every=2,
                               progress_fn=lambda d, note: notes.append((d, note)), **_KW)
    b = tp.simulate_persistent(pos, vel, mass, 4, 1e-3, resort_every=1, **_KW)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert notes == [(2, "drift-guard: per-step resorts"), (4, "")]


def test_robust_persistent_against_exact():
    """Robust mode on a cloud with escapers (test_bh_robust.py:20-28): the
    primed forces within 0.02 of exact, the escapers within 0.02 of their
    own force scale; the outliers ride with G·m 0, and two steps with a
    resort between keep every body and the outliers' G·m."""
    rng = np.random.default_rng(0)
    n = 700
    pos = rng.uniform(-2, 2, (n, 3))
    u = rng.normal(size=(6, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos[:6] = u * 300.0 * rng.uniform(0.5, 1.0, (6, 1))
    mass = rng.uniform(0.04, 1.0, n).astype(np.float32)
    pos, vel = pos.astype(np.float32), np.zeros((n, 3), np.float32)
    st = tp.init_state(*_t(pos, vel, mass), G=G, group_size=B, robust_slots=32, ld=4)
    assert not st.src[st.out_slots, 3].any()
    assert torch.equal(torch.sort(st.out_gm).values,
                       torch.sort(torch.as_tensor(mass)[st.orig[st.out_slots].long()]).values)
    st, _ = tp.prime(st, theta=THETA, softening_sq=EPS2, leaf_cap=64)
    acc = np.zeros((n, 3), np.float32)
    acc[st.orig[st.real].numpy()] = st.acc[st.real].numpy()
    want = accel_exhaustive_f64(pos, mass, G=G)
    assert np.abs(acc - want).max() / np.abs(want).max() < 0.02
    own = np.abs(acc[:6] - want[:6]).max(axis=1) / np.abs(want[:6]).max(axis=1)
    assert own.max() < 0.02
    p_out, _ = tp.simulate_persistent(*_t(pos, vel, mass), 2, 1e-3, resort_every=1,
                                      robust_slots=32, ld=4, **_KW)
    ref, _ = tp.simulate_persistent(*_t(pos, vel, mass), 2, 1e-3, resort_every=2,
                                    robust_slots=32, ld=4, **_KW)
    assert (p_out - ref).abs().max().item() < 1e-5


def test_frames_and_overflow():
    """Frames: the initial one, then each step's positions in the input
    order (equal to a one-step-chunk run's); a frontier overflow raises
    CapacityError naming the cap that fits."""
    pos, vel, mass = _t(*_cloud(300, seed=9))
    frames = []
    p, _ = tp.simulate_persistent(pos, vel, mass, 3, 1e-3, resort_every=2,
                                  frame_writer=frames.append, **_KW)
    allf = np.concatenate(frames)
    assert allf.shape == (4, 300, 3)
    assert np.array_equal(allf[0], pos.numpy()) and np.array_equal(allf[-1], p.numpy())
    pos, vel, mass = _t(*_cloud(2000, seed=9))
    with pytest.raises(CapacityError, match="--bh-frontier-cap 2048"):
        tp.simulate_persistent(pos, vel, mass, 1, 1e-3, frontier_cap=1, leaf_cap=1, ld=4,
                               theta=0.05, **_KW)


# ---- the compositions: adaptive dt, merging, checkpoints --------------------


def test_adaptive_persistent_matches_one_shot_adaptive():
    """test_bh_persistent.py:162-199: simulate_persistent_adaptive against
    the one-shot simulate_adaptive over the fused force (K6's plain version,
    a sort every step) at the same depth and group size: equal steps taken,
    positions within 1e-4 of their scale, velocities within 2e-3."""
    from functools import partial

    from nbody_tpu_torch.core.types import Bodies
    from nbody_tpu_torch.integrate.adaptive import simulate_adaptive
    from nbody_tpu_torch.ops.bh_fused import auto_ld, barneshut_fused

    n = 400
    pos, vel, mass = _t(*_cloud(n, seed=5))
    kw = dict(eta=0.05, softening_sq=EPS2, dt_max=5e-3)
    force = partial(barneshut_fused, G=G, softening_sq=EPS2, theta=THETA, ld=auto_ld(n),
                    group_size=B)
    want, taken_ref = simulate_adaptive(Bodies(pos, vel, mass), 0.0, 1.2e-2, force,
                                        chunk_steps=3, **kw)
    p_got, v_got, taken = tp.simulate_persistent_adaptive(
        pos, vel, mass, 0.0, 1.2e-2, G=G, theta=THETA, group_size=B, resort_every=3, **kw)
    assert taken == taken_ref >= 3
    scale = want.pos.abs().max().item()
    assert (p_got - want.pos).abs().max().item() < 1e-4 * scale
    assert (v_got - want.vel).abs().max().item() < 2e-3


def test_adaptive_persistent_exact_landing_frames_and_checkpoints():
    """test_bh_persistent.py:202-221: 3 steps of dt_max land on t_end, frames
    are the initial one and one row a real step, the last equal to the
    result; checkpoints fire on real step counts with the run's time;
    softening 0 is refused."""
    pos, vel, mass = _t(*_cloud(300, seed=6))
    frames, ckpts = [], []
    p, v, taken = tp.simulate_persistent_adaptive(
        pos, vel, mass, 0.0, 1e-2, G=G, softening_sq=EPS2, theta=THETA, eta=0.5,
        dt_max=4e-3, group_size=B, resort_every=4, frame_writer=frames.append,
        checkpoint_every=2,
        checkpoint_fn=lambda b, s, t: ckpts.append((s, t, b.pos.clone())))
    assert taken == 3 and sum(f.shape[0] for f in frames) == taken + 1
    assert np.array_equal(frames[-1][-1], p.numpy())
    assert [(s, t) for s, t, _ in ckpts] == [(3, float(np.float32(1e-2)))]
    assert torch.equal(ckpts[0][2], p)
    with pytest.raises(ValueError, match="softening_sq > 0"):
        tp.simulate_persistent_adaptive(pos, vel, mass, 0.0, 1e-2, softening_sq=0.0,
                                        dt_max=4e-3, group_size=B)


def _merge_cloud(n, seed=9, pairs=3, gap=5e-4):
    """test_bh_persistent.py:224-238: a random cloud with `pairs` contact
    pairs at distance `gap` (bodies 0 .. 2·pairs - 1)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (n, 3))
    for k in range(pairs):
        pos[2 * k + 1] = pos[2 * k] + [gap, 0, 0]
    return (pos.astype(np.float32), rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
            rng.uniform(0.04, 1.0, n).astype(np.float32))


def test_persistent_merging_matches_one_shot():
    """test_bh_persistent.py:241-271: merging on the persistent layout
    against the one-shot simulate_merging over fp64-direct forces: the
    same merges (masses equal to the bit), positions within 1e-3,
    velocities within 2e-3; checkpoints carry the running masses."""
    from nbody_tpu_torch.core.types import Bodies
    from nbody_tpu_torch.ops.collisions import simulate_merging
    from nbody_tpu_torch.ops.exhaustive import direct_accelerations

    pos, vel, mass = _t(*_merge_cloud(400))
    reports, ckpts = [], []
    p_a, v_a, m_a = tp.simulate_persistent(
        pos, vel, mass, 4, 1e-3, resort_every=2, merge_radius=0.01, merge_every=2,
        merge_report=reports.append, checkpoint_every=2,
        checkpoint_fn=lambda b, s: ckpts.append((s, b.mass.clone())), **_KW)

    def exact(p, m):
        return direct_accelerations(p.double(), m.double(), G=G,
                                    softening_sq=EPS2).to(p.dtype)

    ref, _, nm = simulate_merging(Bodies(pos, vel, mass), 4, 1e-3, exact, radius=0.01,
                                  merge_every=2)
    assert reports == [nm] == [3]
    assert torch.equal(m_a, ref.mass)
    assert (p_a - ref.pos).abs().max().item() < 1e-3
    assert (v_a - ref.vel).abs().max().item() < 2e-3
    assert [s for s, _ in ckpts] == [2, 4] and torch.equal(ckpts[-1][1], m_a)


@pytest.mark.parametrize("robust_slots", [0, 64])
def test_persistent_merging_conserves(robust_slots):
    """test_bh_persistent.py:274-310: three ghosts, mass conserved within
    1e-6, momentum within 5e-3 through the rebuilds, plain and robust (the
    rebuild picks the outliers again from the merged masses); the running
    masses reach mass_update."""
    pos, vel, mass = _merge_cloud(400, seed=11 if robust_slots == 0 else 13)
    if robust_slots:
        pos[-1], pos[-2] = [40.0, 0, 0], [0, -35.0, 0]
    pushed = []
    p, v, m = tp.simulate_persistent(*_t(pos, vel, mass), 6, 1e-3, resort_every=3,
                                     merge_radius=0.01, merge_every=2,
                                     robust_slots=robust_slots, mass_update=pushed.append,
                                     **_KW)
    m64 = m.double().numpy()
    assert np.sum(m64 == 0.0) == 3 and len(pushed) >= 1
    np.testing.assert_allclose(m64.sum(), mass.astype(np.float64).sum(), rtol=1e-6)
    p0 = (mass.astype(np.float64)[:, None] * vel).sum(0)
    p1 = (m64[:, None] * v.double().numpy()).sum(0)
    assert np.abs(p1 - p0).max() < 5e-3
