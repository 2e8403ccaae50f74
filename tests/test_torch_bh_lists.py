"""The port's list-based Barnes-Hut path (nbody_tpu_torch/ops/barneshut.py,
bh_traverse.py, bh_traverse_flat.py) on the CPU, where K7's wrappers take
their plain version, held against the JAX package's jnp path and against
tests/oracle.py.

The JAX side runs once per dtype, in one compiled function of a
module-scoped fixture: each static configuration of JAX's pipeline
compiles anew, at several seconds each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import oracle
from conftest import random_cloud
from nbody_tpu.ops import barneshut as jb
from nbody_tpu.ops import bh_traverse as jt
from nbody_tpu.ops import bh_traverse_flat as jtf
from nbody_tpu_torch.core.capacity import CapacityError
from nbody_tpu_torch.ops import barneshut as tb
from nbody_tpu_torch.ops import cuda_lists
from nbody_tpu_torch.ops.bh_traverse import traverse
from nbody_tpu_torch.ops.bh_traverse_flat import owning_ranges, traverse_flat
from nbody_tpu_torch.ops.bh_tree import levels_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EPS2, THETA = 0.01, 0.5
# one fixture: 600 bodies, B = 64 (split level 2, 74 group slots, some
# empty), depth 6, lists of 2048, the padded traversal's F = R = 512
N, B, DEPTH, M, F, R = 600, 64, 6, 2048, 512, 512
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.fixture(scope="module")
def jax_run():
    """Per dtype: JAX's prepared state (levels, border, group boxes, sorted
    bodies), both traversals' outputs, _eval_lists_jnp on the flat lists,
    and barneshut_accelerations with each traversal."""
    arr = random_cloud(N, seed=53)
    b, sl, lc = jb.auto_layout(N, B, 0)
    depth = max(jb.effective_depth(N, DEPTH, lc, b), sl + 3)
    kw = dict(G_const=1.0, theta=THETA, leaf_cap=lc, list_size=M)
    out = {}
    for name, (jdt, _) in DTYPES.items():

        @jax.jit
        def run(pos, mass, jdt=jdt):
            (_, _, levels, border, pos_s, mass_s, _, _, pg, lo, hi) = jb._prepare(
                pos, mass, depth, b, sl)
            gm_s = jnp.asarray(1.0, jdt) * mass_s
            args = (levels, border.astype(jdt), lo, hi, pos_s, gm_s)
            flat = jtf.traverse_flat(*args, **kw)
            padded = jt.traverse(*args, frontier_size=F, range_size=R, **kw)
            ev = jb._eval_lists_jnp(pg, flat[0].astype(jdt), eps2=EPS2)
            accs = {t: jb.barneshut_accelerations(
                pos, mass, backend="jnp", depth=DEPTH, group_size=B, list_size=M,
                frontier_size=F, range_size=R, traversal=t) for t in ("flat", "padded")}
            return args, pg, flat, padded, ev, accs

        out[name] = run(jnp.asarray(arr[:, :3], jdt), jnp.asarray(arr[:, 6], jdt))
    return arr, lc, out


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("traversal", ["flat", "padded"])
def test_traversals_on_jax_levels_match_exactly(jax_run, name, traversal):
    """JAX's levels, border and group boxes carried across: the port's
    traversal gives JAX's lists (compared in JAX's (G, 4, M) order),
    lengths and every stats field exactly."""
    _, lc, out = jax_run
    (levels, border, lo, hi, pos_s, gm_s), _, flat, padded, _, _ = out[name]
    args = (levels_from_numpy(levels), _t(border), _t(lo), _t(hi), _t(pos_s), _t(gm_s))
    kw = dict(G_const=1.0, theta=THETA, leaf_cap=lc, list_size=M)
    if traversal == "flat":
        lists, lengths, stats = traverse_flat(*args, **kw)
        want = flat
    else:
        lists, lengths, stats = traverse(*args, frontier_size=F, range_size=R, **kw)
        want = padded
    assert lists.shape == (lo.shape[0], M, 4) and lists.is_contiguous()
    assert lists.dtype == DTYPES[name][1] and lengths.dtype == torch.int32
    np.testing.assert_array_equal(lists.numpy().transpose(0, 2, 1), np.asarray(want[0]))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want[1]))
    for field, got, w in zip(stats._fields, stats, want[2]):
        assert int(got) == int(w), field
    assert int(stats.max_list_needed) > 100  # far COMs and near bodies
    assert int((lengths == 1).sum()) > 0  # empty groups took the root's COM


def test_owning_ranges_match_jax_running_max():
    """The ragged expansion's owning range of every body slot, against
    JAX's scatter-max + cummax (bh_traverse_flat.py:285-290), with empty
    ranges inside and at the end, and a body store shorter and longer
    than the bodies."""
    rng = np.random.default_rng(4)
    rc = rng.integers(0, 6, 300)
    rc[rng.random(300) < 0.3] = 0
    rc[250:] = 0
    cum = np.cumsum(rc) - rc
    for body_cap in (int(rc.sum()) // 2, int(rc.sum()) + 40):
        jrc, jcum = jnp.asarray(rc, jnp.int32), jnp.asarray(cum, jnp.int32)
        rid0 = (jnp.zeros((body_cap + 1,), jnp.int32)
                .at[jnp.where(jrc > 0, jcum, body_cap)]
                .max(jnp.arange(300, dtype=jnp.int32), mode="drop")[:body_cap])
        want = np.asarray(lax.cummax(rid0))
        np.testing.assert_array_equal(owning_ranges(torch.as_tensor(rc), body_cap).numpy(),
                                      want)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_eval_lists_reference_matches_jnp(jax_run, name):
    """K7's plain version against _eval_lists_jnp on the same groups and
    lists: f32 within K1's bound (test_pallas.py:25), f64 within 1e-12."""
    _, _, out = jax_run
    _, pg, flat, _, ev, _ = out[name]
    lists = _t(np.asarray(flat[0]).transpose(0, 2, 1).copy())
    want = np.asarray(ev)
    before = cuda_lists.eval_lists.launches + cuda_lists.eval_lists_f64.launches
    wrapper = cuda_lists.eval_lists if name == "f32" else cuda_lists.eval_lists_f64
    got = wrapper(_t(pg), lists, _t(flat[1]), eps2=EPS2)
    assert cuda_lists.eval_lists.launches + cuda_lists.eval_lists_f64.launches == before
    np.testing.assert_array_equal(got.numpy(), cuda_lists.eval_lists_reference(
        _t(pg), lists, eps2=EPS2).numpy())  # CPU tensors: the plain version
    scale = np.abs(want).max()
    if name == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * scale, rtol=2e-4)
    else:
        assert np.abs(got.numpy() - want).max() <= 1e-12 * scale


def test_eval_lists_refuses_mismatched_inputs():
    pg = torch.zeros((2, 4, 3))
    with pytest.raises(TypeError):
        cuda_lists.eval_lists(pg.double(), torch.zeros((2, 8, 4)).double(),
                              torch.ones(2, dtype=torch.int32), eps2=EPS2)
    with pytest.raises(ValueError):
        cuda_lists.eval_lists(pg, torch.zeros((3, 8, 4)), torch.ones(3, dtype=torch.int32),
                              eps2=EPS2)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("traversal", ["flat", "padded"])
def test_pipeline_matches_jax(jax_run, name, traversal):
    """The whole port pipeline (own sort and tree) against JAX's jnp path:
    f32 within 1e-5 of the force scale and rtol 1e-4 (test_barneshut.py:158),
    f64 within 1e-12 of the force scale."""
    arr, _, out = jax_run
    want = np.asarray(out[name][5][traversal])
    tdt = DTYPES[name][1]
    acc, stats = tb.barneshut_accelerations(
        _t(arr[:, :3], tdt), _t(arr[:, 6], tdt), depth=DEPTH, group_size=B, list_size=M,
        frontier_size=F, range_size=R, traversal=traversal, return_stats=True)
    assert acc.dtype == tdt and not stats.overflowed()
    scale = np.abs(want).max()
    if name == "f32":
        np.testing.assert_allclose(acc.numpy(), want, atol=1e-5 * scale, rtol=1e-4)
    else:
        assert np.abs(acc.numpy() - want).max() <= 1e-12 * scale


def _forces(n, seed, **kw):
    arr = random_cloud(n, seed=seed)
    acc = tb.barneshut_accelerations(_t(arr[:, :3], torch.float32),
                                     _t(arr[:, 6], torch.float32), **kw).numpy()
    return arr, acc, oracle.accel_exhaustive(arr[:, :3], arr[:, 6])


def test_bh_close_to_exhaustive():
    """Twin of tests/test_barneshut.py::test_bh_close_to_exhaustive."""
    _, acc, a_ex = _forces(1000, 13, depth=8, group_size=64)
    assert np.abs(acc - a_ex).max() / np.abs(a_ex).max() < 0.01


def test_bh_tight_theta_is_nearly_exact():
    """Twin of tests/test_barneshut.py::test_bh_tight_theta_is_nearly_exact."""
    _, acc, a_ex = _forces(300, 17, theta=0.05, depth=8, group_size=32,
                           frontier_size=4096, list_size=4096)
    assert np.abs(acc - a_ex).max() / np.abs(a_ex).max() < 2e-3


def test_bh_unaligned_n_padding():
    """Twin of tests/test_barneshut.py::test_bh_unaligned_n_padding."""
    _, acc, a_ex = _forces(333, 19, depth=8, group_size=64)
    assert acc.shape == (333, 3)
    assert np.abs(acc - a_ex).max() / np.abs(a_ex).max() < 0.01


def test_capacity_overflow_detected():
    """Twin of tests/test_barneshut.py::test_capacity_overflow_detected; the
    message names the list size that fits, and that size passes."""
    arr = random_cloud(1000, seed=23)
    pos, mass = _t(arr[:, :3], torch.float32), _t(arr[:, 6], torch.float32)
    with pytest.raises(CapacityError, match="capacity overflow") as e:
        tb.check_capacities(pos, mass, depth=8, group_size=64, list_size=128)
    need = int(str(e.value).split("--bh-list-size ")[1].split()[0])
    assert need > 128
    stats = tb.check_capacities(pos, mass, depth=8, group_size=64, list_size=need)
    assert not stats.overflowed() and int(stats.traverse.max_list_needed) == need
    stats = tb.check_capacities(pos, mass, depth=8, group_size=64, frontier_size=2048,
                                list_size=4096)
    assert not stats.overflowed()


def test_flat_and_padded_traversals_agree():
    """Twin of tests/test_barneshut.py::test_flat_and_padded_traversals_agree."""
    arr = random_cloud(1500, seed=53)
    pos, mass = _t(arr[:, :3], torch.float32), _t(arr[:, 6], torch.float32)
    kw = dict(depth=8, group_size=64)
    a_flat = tb.barneshut_accelerations(pos, mass, traversal="flat", **kw).numpy()
    a_pad = tb.barneshut_accelerations(pos, mass, traversal="padded", **kw).numpy()
    a_ex = oracle.accel_exhaustive(arr[:, :3], arr[:, 6])
    scale = np.abs(a_ex).max()
    assert np.abs(a_flat - a_pad).max() / scale < 2e-3
    err_flat = np.abs(a_flat - a_ex).max() / scale
    err_pad = np.abs(a_pad - a_ex).max() / scale
    assert err_flat <= err_pad * 1.5 + 1e-4, (err_flat, err_pad)


def test_coincident_bodies_do_not_nan():
    """Twin of tests/test_bh_clustered.py::test_coincident_bodies_do_not_nan."""
    acc = tb.barneshut_accelerations(torch.zeros((512, 3)), torch.ones(512)).numpy()
    assert np.isfinite(acc).all()
    np.testing.assert_allclose(acc, 0.0, atol=1e-5)


def test_single_body():
    """Twin of tests/test_bh_clustered.py::test_single_body."""
    acc = tb.barneshut_accelerations(torch.tensor([[1.0, 2.0, 3.0]]),
                                     torch.tensor([5.0])).numpy()
    np.testing.assert_allclose(acc, 0.0, atol=1e-6)


def test_unknown_traversal_refused():
    with pytest.raises(ValueError, match="traversal"):
        tb.barneshut_accelerations(torch.zeros((4, 3)), torch.ones(4), traversal="fused")
