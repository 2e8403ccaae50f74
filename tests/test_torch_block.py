"""The port's block time-step tiers on the persistent layout
(nbody_tpu_torch/ops/bh_persistent.py), through K6's plain version on the
CPU: the tier assignment and the prefix plan against the JAX package's,
and twins of tests/test_bh_block.py's invariants, held to the bit where the
port's schedule makes them exact."""

import math
from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import bh_persistent as jp
from nbody_tpu_torch.diag.energy import energy_drift, get_energy
from nbody_tpu_torch.ops import bh_persistent as tp
from nbody_tpu_torch.utils.fixtures import plummer_cloud


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EPS2, N, GS = 1e-4, 1024, 128  # tests/test_bh_block.py:23-25
FKW = dict(theta=0.5, softening_sq=EPS2, leaf_cap=64)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)


def _state(n=N, seed=7, robust_slots=0, outliers=False):
    """A primed state of tests/test_bh_block.py:28-39's Plummer sphere
    (optionally with 4 bodies flung x40, :199-203)."""
    arr = plummer_cloud(n, seed=seed, total_mass=1.0, G=1.0)
    if outliers:
        arr[:4, 0:3] *= 40.0
    st = tp.init_state(_t(arr[:, :3]), _t(arr[:, 3:6]), _t(arr[:, 6]), G=1.0, group_size=GS,
                       robust_slots=robust_slots)
    st, _ = tp.prime(st, **FKW)
    return st, _t(arr[:, 6])


def _copy(st):
    """The steppers update the state's arrays in place."""
    return st._replace(src=st.src.clone(), vel=st.vel.clone(), acc=st.acc.clone())


@pytest.fixture(scope="module")
def primed():
    return _state()


def _energy(st, mass):
    p, v = tp.emit(st)
    ke, pe = get_energy(p.double(), v.double(), mass.double(), G=1.0)
    return float(ke + pe)


def test_tier_order_sizes_match_jax():
    """tests/test_bh_block.py:160-176's plan, and random tiers at the CLI's
    quantum of 64: order and sizes equal to JAX's."""
    tiers = np.int32([0, 2, 1, 2, 0, 1, 1, 0])
    for quant, want in ((2, (2, 6, 8)), (1, (2, 5, 8))):
        order, sizes = tp.tier_order_sizes(torch.as_tensor(tiers), 3, quant=quant)
        j_order, j_sizes = jp.tier_order_sizes(jnp.asarray(tiers), 3, quant=quant)
        assert sizes == j_sizes == want and np.array_equal(order, np.asarray(j_order))
    rng = np.random.default_rng(0)
    for n_tiers in (2, 3, 4):
        tiers = rng.integers(0, n_tiers, 700).astype(np.int32)
        order, sizes = tp.tier_order_sizes(torch.as_tensor(tiers), n_tiers)
        j_order, j_sizes = jp.tier_order_sizes(jnp.asarray(tiers), n_tiers)
        assert sizes == j_sizes and np.array_equal(order, np.asarray(j_order))


@pytest.mark.parametrize("dt,n_tiers", [(1e-2, 4), (0.03, 3)])
def test_assign_tiers_matches_jax(primed, dt, n_tiers):
    """The same accelerations through JAX's assign_tiers (a stand-in with
    its planar (G, 3, B) acc and (G, B) valid): equal tiers; the Plummer
    core is hotter than its halo (tests/test_bh_block.py:70-87)."""
    st, _ = primed
    g = st.gcount.shape[0]
    stand_in = namedtuple("State", "acc valid")(
        jnp.asarray(st.acc.numpy().reshape(g, GS, 3).transpose(0, 2, 1)),
        jnp.asarray(st.valid.numpy().reshape(g, GS)))
    kw = dict(eta=0.01, eps=math.sqrt(EPS2), n_tiers=n_tiers)
    got = tp.assign_tiers(st, dt, **kw).numpy()
    assert np.array_equal(got, np.asarray(jp.assign_tiers(stand_in, dt, **kw)))
    occupied = st.gcount.numpy() > 0
    assert len(np.unique(got[occupied])) >= 2 and got.max() <= n_tiers - 1


def test_uniform_coarse_tier_is_kdk_bit_for_bit(primed):
    """Every group on tier 0 of 2: kicks and evaluations land on the macro
    boundaries and a group's drift over its step is one v·dt, so the state
    is kdk_steps' at dt to the bit (JAX: within 1e-5, two half-drifts)."""
    st, _ = primed
    tiers = torch.zeros(st.gcount.shape[0], dtype=torch.int32)
    a, _, _ = tp.kdk_block_steps(_copy(st), tiers, 3, 1e-3, n_tiers=2, **FKW)
    b, _, _ = tp.kdk_steps(_copy(st), 3, 1e-3, **FKW)
    assert torch.equal(a.src, b.src) and torch.equal(a.vel, b.vel)
    assert torch.equal(a.acc, b.acc)


def test_uniform_finest_tier_is_kdk_at_small_dt(primed):
    """Every group on the finest tier of 3: kdk_steps at dt/4 for four
    times the steps, to the bit."""
    st, _ = primed
    tiers = torch.full((st.gcount.shape[0],), 2, dtype=torch.int32)
    a, _, _ = tp.kdk_block_steps(_copy(st), tiers, 2, 1e-3, n_tiers=3, **FKW)
    b, _, _ = tp.kdk_steps(_copy(st), 8, 1e-3 / 4, **FKW)
    assert torch.equal(a.src, b.src) and torch.equal(a.vel, b.vel)


@pytest.mark.parametrize("robust", [False, True])
def test_prefix_is_masked_bit_for_bit(robust):
    """kdk_block_prefix_steps against kdk_block_steps on hand-mixed tiers
    (tests/test_bh_block.py:185-236), with exact prefixes and with
    quantization extras (evaluated, dropped, never kicked): positions,
    velocities and accelerations equal to the bit, plain and robust (the
    robust rectangle shrinks to the prefix's targets)."""
    st, _ = _state(512, seed=11, robust_slots=64 if robust else 0, outliers=robust)
    assert (st.out_gm is not None) == robust
    n_tiers = 2 if robust else 3
    tiers = torch.as_tensor(np.arange(st.gcount.shape[0]) % n_tiers, dtype=torch.int32)
    ref, _, _ = tp.kdk_block_steps(_copy(st), tiers, 2, 1e-3, n_tiers=n_tiers, **FKW)
    for quant in (1, 4):
        order, sizes = tp.tier_order_sizes(tiers, n_tiers, quant=quant)
        got, _, _ = tp.kdk_block_prefix_steps(_copy(st), tiers, order, 2, 1e-3, sizes=sizes,
                                              n_tiers=n_tiers, **FKW)
        for name in ("src", "vel", "acc"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), (quant, name)


def test_mixed_tiers_energy_and_eval_budget(primed):
    """tests/test_bh_block.py:95-133: at dt = 0.03 the core takes tier 2 of
    3 and the halo tier 0; the block run's drift is under half the coarse
    run's, at under 0.7 of the uniformly fine run's group evaluations."""
    st, mass = primed
    dt, k = 0.03, 3
    e0 = _energy(st, mass)
    tiers = tp.assign_tiers(st, dt, eta=0.01, eps=math.sqrt(EPS2), n_tiers=k)
    t_np, occ = tiers.numpy(), st.gcount.numpy() > 0
    assert t_np[occ].max() == k - 1 and t_np[occ].min() == 0
    blk, _, _ = tp.kdk_block_steps(_copy(st), tiers, 4, dt, n_tiers=k, **FKW)
    coarse, _, _ = tp.kdk_steps(_copy(st), 4, dt, **FKW)
    d_blk = abs(energy_drift(_energy(blk, mass), e0))
    d_coarse = abs(energy_drift(_energy(coarse, mass), e0))
    assert d_blk < 0.5 * d_coarse, (d_blk, d_coarse)
    s_per = 1 << (k - 1)
    big_l = s_per >> t_np
    evals_block = sum(int((((s + 1) % big_l) == 0)[occ].sum()) for s in range(s_per))
    assert evals_block < 0.7 * s_per * int(occ.sum())


@pytest.mark.parametrize("prefix", [False, True])
def test_simulate_persistent_block_mode(prefix):
    """tests/test_bh_block.py:136-157: block_tiers=2 with resorts and frames
    stays finite, conserves energy within 1e-2 and writes one frame row
    per macro step; masked and prefix runs are the same bits."""
    arr = plummer_cloud(N, seed=9, total_mass=1.0, G=1.0)
    pos, vel, mass = _t(arr[:, :3]), _t(arr[:, 3:6]), _t(arr[:, 6])
    frames = []
    p, v = tp.simulate_persistent(pos, vel, mass, 6, 1e-3, G=1.0, softening_sq=EPS2,
                                  group_size=GS, resort_every=3, frame_writer=frames.append,
                                  block_tiers=2, block_eta=0.01, block_prefix=prefix)
    assert bool(torch.isfinite(p).all()) and sum(f.shape[0] for f in frames) == 7
    ke0, pe0 = get_energy(pos.double(), vel.double(), mass.double(), G=1.0)
    ke1, pe1 = get_energy(p.double(), v.double(), mass.double(), G=1.0)
    assert abs(energy_drift(float(ke1 + pe1), float(ke0 + pe0))) < 1e-2
    other = tp.simulate_persistent(pos, vel, mass, 6, 1e-3, G=1.0, softening_sq=EPS2,
                                   group_size=GS, resort_every=3, block_tiers=2,
                                   block_eta=0.01, block_prefix=not prefix)
    assert torch.equal(other[0], p) and torch.equal(other[1], v)


def test_block_refusals():
    """Tiers need softening_sq > 0, and refuse merging
    (bh_persistent.py:1169-1170, 1191-1195)."""
    pos, vel, mass = _t(np.zeros((8, 3))), _t(np.zeros((8, 3))), _t(np.ones(8))
    with pytest.raises(ValueError, match="softening_sq > 0"):
        tp.simulate_persistent(pos, vel, mass, 1, 1e-3, softening_sq=0.0, block_tiers=2)
    with pytest.raises(ValueError, match="cannot combine"):
        tp.simulate_persistent(pos, vel, mass, 1, 1e-3, block_tiers=2, merge_radius=0.1)


def test_stratified_fixture_matches_the_jax_recipe():
    """stratified_cloud is tools/profile_block.py:43-58's input, built here
    on the JAX package's plummer_cloud: equal arrays; at dt 0.01 its tiers
    split three ways, the core's groups fine."""
    from nbody_tpu.utils.fixtures import plummer_cloud as jax_plummer
    from nbody_tpu_torch.utils.fixtures import stratified_cloud

    n = 2000
    rng = np.random.default_rng(3)
    core = jax_plummer(n // 10, seed=3, total_mass=0.5, G=1.0)
    core[:, 0:3] *= 0.05
    core[:, 3:6] *= math.sqrt(1.0 / 0.05)
    u = rng.normal(size=(n - n // 10, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = 10.0 * rng.uniform(0.2, 1.0, n - n // 10)[:, None] ** (1 / 3)
    halo = np.concatenate([u * r, rng.normal(0, 0.05, (n - n // 10, 3)),
                           np.full((n - n // 10, 1), 0.5 / (n - n // 10))], axis=1)
    arr = stratified_cloud(n)
    assert np.array_equal(arr, np.concatenate([core, halo]))
    st = tp.init_state(_t(arr[:, :3]), _t(arr[:, 3:6]), _t(arr[:, 6]), G=1.0, group_size=GS)
    st, _ = tp.prime(st, **FKW)
    tiers = tp.assign_tiers(st, 0.01, eta=0.01, eps=math.sqrt(EPS2), n_tiers=3).numpy()
    occupied = tiers[st.gcount.numpy() > 0]
    assert occupied.min() == 0 and occupied.max() == 2
