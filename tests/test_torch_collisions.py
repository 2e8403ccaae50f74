"""The port's inelastic merging (nbody_tpu_torch/ops/collisions.py, and
its stepping loop in nbody_tpu_torch/integrate/leapfrog.py) held against
the JAX package's jnp ``merge_pass`` and ``simulate_merging``, and twins
of tests/test_collisions.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core.types import Bodies as JBodies
from nbody_tpu.ops import collisions as jc
from nbody_tpu.ops.exhaustive import exhaustive_accelerations as jax_exhaustive
from nbody_tpu_torch.core.types import Bodies
from nbody_tpu_torch.integrate.leapfrog import leapfrog_steps, simulate, simulate_merging
from nbody_tpu_torch.ops import collisions as tc
from nbody_tpu_torch.ops.exhaustive import exhaustive_accelerations


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _contact_set(seed, n=300):
    """A random f32 cloud with a chain of five bodies at spacing 0.03 (each
    in contact with its neighbours only), a pair whose higher index lies
    first in space, and every 17th body a ghost (mass 0) from an earlier
    pass."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    for i in range(1, 5):
        pos[10 + i] = pos[10] + np.float32([0.03 * i, 0, 0])
    pos[40] = pos[200] + np.float32([0, 0.02, 0])
    vel = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.1, 1, n).astype(np.float32)
    mass[::17] = 0.0
    return pos, vel, mass


@pytest.mark.parametrize("seed,radius", [(0, 0.05), (1, 0.1), (2, 0.15)])
def test_merge_pass_matches_jax(seed, radius):
    """Against JAX's merge_pass on the same set: n_merged and the absorbed
    set equal exactly; each mass within one f32 ulp of JAX's (JAX sums in
    f32, the port in fp64 rounded once); positions and velocities within
    2 ulp of their scale (1 and 1: 2.4e-7)."""
    pos, vel, mass = _contact_set(seed)
    jp, jv, jm, jn = jc.merge_pass(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
                                   radius)
    p, v, m, nm = tc.merge_pass(*_t(pos, vel, mass), radius)
    jm = np.asarray(jm)
    assert int(nm) == int(jn) > 0
    absorbed = (mass > 0) & (m.numpy() == 0)
    assert np.array_equal(absorbed, (mass > 0) & (jm == 0))
    assert np.all(np.abs(m.numpy() - jm) <= np.spacing(np.abs(jm)))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=2.4e-7, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=2.4e-7, rtol=0)
    if radius == 0.05:  # the chain 10..14 collapses to body 10, in one pass
        assert m[10] > 0 and not m[11:15].any() and absorbed[200] and m[40] > 0


def test_lowest_partner_not_nearest():
    """Each body takes its lowest-index partner in contact, not its nearest,
    and adopts it only when that index is below its own: body 2 touches 0
    and the nearer 1 and merges into 0; body 1 touches only 2, a higher
    index, and stays."""
    pos = torch.tensor([[0.0, 0, 0], [0.18, 0, 0], [0.095, 0, 0], [5.0, 0, 0]])
    live = torch.ones(4, dtype=torch.bool)
    part = tc.lowest_partners(pos, live, torch.tensor(0.1**2))
    assert part.tolist() == [2, 2, 0, 4]
    p, v, m, nm = tc.merge_pass(pos, torch.zeros(4, 3), torch.ones(4), 0.1)
    assert int(nm) == 1 and m.tolist() == [2.0, 1.0, 0.0, 1.0]


def test_contact_chunks_change_no_partner(monkeypatch):
    """The contact test's row chunk changes no partner: with the budget at
    0 a chunk is 8 rows, and 40 bodies in contact across chunks take the
    partners of the one-chunk test."""
    rng = np.random.default_rng(7)
    pos = torch.from_numpy(rng.uniform(0.0, 1.0, (40, 3)).astype(np.float32))
    live = torch.from_numpy(rng.uniform(size=40) > 0.1)
    r2 = torch.tensor(0.3**2)
    assert tc.merge_chunk(40) == 40
    whole = tc.lowest_partners(pos, live, r2)
    monkeypatch.setattr(tc, "_CHUNK_BUDGET", 0)
    assert tc.merge_chunk(40) == 8
    assert torch.equal(tc.lowest_partners(pos, live, r2), whole)
    assert (whole < 40).sum() > 20 and not bool((whole[~live] < 40).any())


def test_two_body_merge_conserves():
    """tests/test_collisions.py:16-34: mass and momentum, the COM, the ghost
    at the merged state, the bystander untouched."""
    pos = torch.tensor([[0.0, 0, 0], [0.05, 0, 0], [5.0, 5, 5]])
    vel = torch.tensor([[1.0, 0, 0], [-1.0, 0, 0], [0.1, 0, 0]])
    p, v, m, nm = tc.merge_pass(pos, vel, torch.tensor([2.0, 1.0, 3.0]), 0.1)
    assert int(nm) == 1 and m.tolist() == [3.0, 0.0, 3.0]
    assert torch.allclose(v[0], torch.tensor([1 / 3, 0, 0]), atol=1e-7)
    assert torch.allclose(p[0], torch.tensor([0.05 / 3, 0, 0]), atol=1e-8)
    assert torch.equal(p[1], p[0]) and torch.equal(v[1], v[0])
    assert torch.equal(p[2], pos[2]) and torch.equal(v[2], vel[2])


def test_ghosts_never_remerge_and_no_merge_is_identity():
    """A ghost keeps its state and merges with nothing; a pass that merges
    nothing returns the state bit for bit ((m·p)/m is exact in fp64)."""
    pos = torch.tensor([[0.0, 0, 0], [0.05, 0, 0]])
    p, v, m, nm = tc.merge_pass(pos, torch.zeros(2, 3), torch.tensor([1.0, 0.0]), 0.1)
    assert int(nm) == 0 and torch.equal(p, pos)
    rng = np.random.default_rng(3)
    pos, vel, mass = _t(*(rng.uniform(0.1, 1, s).astype(np.float32) for s in
                          ((64, 3), (64, 3), (64,))))
    p, v, m, nm = tc.merge_pass(pos, vel, mass, 1e-9)
    assert int(nm) == 0
    assert torch.equal(p, pos) and torch.equal(v, vel) and torch.equal(m, mass)


def _force_pair():
    def tforce(p, m):
        return exhaustive_accelerations(p, m, G=1.0)

    def jforce(p, m):
        return jax_exhaustive(p, m, G=1.0)
    return tforce, jforce


def test_simulate_merging_matches_jax_head_on():
    """tests/test_collisions.py:78-98 on both packages: two bodies launched
    at each other merge once mid-run, at the same step; masses equal, the
    merged body at rest within 1e-3, final states within 1e-5."""
    pos = np.float32([[-1.0, 0, 0], [1.0, 0, 0]])
    vel = np.float32([[2.0, 0, 0], [-2.0, 0, 0]])
    mass = np.float32([1.0, 1.0])
    tforce, jforce = _force_pair()
    jout, _, jn = jc.simulate_merging(JBodies(*map(jnp.asarray, (pos, vel, mass))), 200,
                                      0.01, jforce, radius=0.2, merge_every=1)
    out, _, nm, hist = simulate_merging(Bodies(*_t(pos, vel, mass)), 200, 0.01, tforce,
                                           radius=0.2, merge_every=1, with_history=True)
    assert nm == int(jn) == 1 and hist.shape == (200, 2, 3)
    assert np.array_equal(out.mass.numpy(), np.asarray(jout.mass))
    assert out.vel[int(out.mass.argmax())].abs().max().item() < 1e-3
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos), atol=1e-5, rtol=0)


def test_no_merge_is_plain_leapfrog_bit_for_bit():
    """tests/test_collisions.py:101-127: with a radius nothing reaches, the
    merging loop is the plain KDK loop, here to the bit."""
    rng = np.random.default_rng(1)
    b = Bodies(*_t(rng.uniform(-2, 2, (64, 3)).astype(np.float32),
                   rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32),
                   rng.uniform(0.1, 1, 64).astype(np.float32)))
    tforce, _ = _force_pair()
    want, _ = leapfrog_steps(b, 20, 1e-3, tforce)
    got, _, nm = simulate_merging(b, 20, 1e-3, tforce, radius=1e-9, merge_every=4)
    assert nm == 0 and torch.equal(want.pos, got.pos) and torch.equal(want.vel, got.vel)


def test_simulate_with_merging_chunks_on_merge_boundaries():
    """simulate(merge_radius=...) with frames lands its chunks on merge
    boundaries, reports the total, pushes the running masses after merging
    chunks, and refuses a non-leapfrog integrator; a radius reaching every
    pair leaves one live body."""
    b = Bodies.from_numpy(np.concatenate([np.random.default_rng(4).uniform(-1, 1, (12, 6)),
                                          np.full((12, 1), 0.5)], 1))
    tforce, _ = _force_pair()
    chunks, masses, report = [], [], []
    out = simulate(b, 7, 1e-3, tforce, frame_writer=chunks.append, chunk_steps=64,
                   merge_radius=10.0, merge_every=3, merge_report=report.append,
                   mass_update=masses.append)
    assert [c.shape[0] for c in chunks] == [1, 3, 3, 1]
    assert report == [11] and len(masses) == 1 and (masses[0] > 0).sum() == 1
    assert torch.equal(out.mass, torch.as_tensor(masses[0]))
    with pytest.raises(ValueError, match="leapfrog"):
        simulate(b, 2, 1e-3, tforce, merge_radius=1.0, integrator="yoshida4")
