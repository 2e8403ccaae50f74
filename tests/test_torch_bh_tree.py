"""The port's level tree (nbody_tpu_torch/ops/bh_tree.py) and its dumps
(nbody_tpu_torch/diag/treedump.py) on the CPU, held against the JAX
package's build_tree and tests/test_barneshut.py's structure checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_cloud
from nbody_tpu.ops import bh_tree as jtree
from nbody_tpu.ops import morton as jm
from nbody_tpu_torch.diag.treedump import level_summary, print_tree_indented
from nbody_tpu_torch.ops.bh_tree import build_tree, levels_from_numpy
from nbody_tpu_torch.ops.morton import morton_sort


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (dtype, n, depth, seed, relative tolerance of the float sums: the port
# sums coarse levels from their children, JAX every level from the bodies)
CASES = {"f32": (jnp.float32, torch.float32, 1500, 8, 31, 1e-6),
         "f64": (jnp.float64, torch.float64, 600, 6, 32, 1e-12)}


def _port_tree(arr, depth, dtype=torch.float64):
    pos = torch.as_tensor(arr[:, :3], dtype=dtype)
    mass = torch.as_tensor(arr[:, 6], dtype=dtype)
    perm, keys, _ = morton_sort(pos, depth)
    return perm, build_tree(pos[perm], mass[perm], keys[perm], depth)


@pytest.fixture(scope="module")
def jax_trees():
    """JAX's permutation and levels for each case, one compile each."""
    out = {}
    for name, (jdt, _, n, depth, seed, _) in CASES.items():
        arr = random_cloud(n, seed=seed)

        @jax.jit
        def tree(pos, mass, depth=depth):
            perm, keys, _ = jm.morton_sort(pos, depth)
            return perm, jtree.build_tree(pos[perm], mass[perm], keys[perm], depth)

        out[name] = arr, tree(jnp.asarray(arr[:, :3], jdt), jnp.asarray(arr[:, 6], jdt))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_tree_matches_jax(jax_trees, name):
    """Counts, starts and child links equal JAX's exactly; masses within
    1e-6 relative in f32 and 1e-12 in f64, centres of mass within that
    fraction of the coordinate scale: a centre near 0 is a sum that
    cancels, whose rounding scales with the coordinates, not with it."""
    _, tdt, _, depth, _, rtol = CASES[name]
    arr, (jperm, jlevels) = jax_trees[name]
    perm, levels = _port_tree(arr, depth, tdt)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert len(levels) == len(jlevels) == depth + 1
    for d, (got, want) in enumerate(zip(levels, levels_from_numpy(jlevels))):
        assert got.capacity == want.capacity, d
        for field in ("count", "start", "child_start", "child_count"):
            assert getattr(got, field).dtype == torch.int32
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          getattr(want, field).numpy(), err_msg=f"{field} {d}")
        assert got.mass.dtype == got.com.dtype == tdt
        np.testing.assert_allclose(got.mass.numpy(), want.mass.numpy(), rtol=rtol, atol=0)
        np.testing.assert_allclose(got.com.numpy(), want.com.numpy(), rtol=0,
                                   atol=rtol * np.abs(arr[:, :3]).max())


def test_levels_from_numpy_keeps_dtypes(jax_trees):
    _, (_, jlevels) = jax_trees["f32"]
    lv = levels_from_numpy(jlevels)[3]
    assert lv.com.dtype == lv.mass.dtype == torch.float32
    assert lv.count.dtype == lv.child_start.dtype == torch.int32
    assert lv.com.is_contiguous() and lv.com.shape == (lv.capacity, 3)


def test_tree_mass_conservation():
    """Twin of tests/test_barneshut.py::test_tree_mass_conservation."""
    arr = random_cloud(500, seed=21)
    _, levels = _port_tree(arr, 6)
    total = float(np.sum(arr[:, 6]))
    global_com = (arr[:, 6:7] * arr[:, :3]).sum(0) / total
    for d, lvl in enumerate(levels):
        assert float(lvl.mass.sum()) == pytest.approx(total, rel=1e-12), d
        assert int(lvl.count.sum()) == 500
        m, com = lvl.mass.numpy(), lvl.com.numpy()
        np.testing.assert_allclose((m[:, None] * com).sum(0) / total, global_com,
                                   rtol=1e-10)


def test_tree_child_links():
    """Twin of tests/test_barneshut.py::test_tree_child_links; empty slots
    hold start 0 and child_count 0."""
    arr = random_cloud(200, seed=22)
    _, levels = _port_tree(arr, 5)
    for d in range(len(levels) - 1):
        pc = levels[d].count.numpy()
        cs = levels[d].child_start.numpy()
        cc = levels[d].child_count.numpy()
        child_cnt = levels[d + 1].count.numpy()
        for k in np.nonzero(pc > 0)[0]:
            assert cc[k] >= 1
            assert child_cnt[cs[k]:cs[k] + cc[k]].sum() == pc[k]
        empty = pc == 0
        assert (cc[empty] == 0).all() and (levels[d].start.numpy()[empty] == 0).all()
    assert (levels[-1].child_count.numpy() == 0).all()


def test_level_summary():
    """Twin of tests/test_treedump.py::test_level_summary."""
    _, levels = _port_tree(random_cloud(300, seed=61), 4)
    lines = level_summary(levels).splitlines()
    assert len(lines) == 5  # depth 4 -> levels 0..4
    assert "level 0: 1 nodes" in lines[0]
    assert "bodies 300" in lines[0]  # every level covers all bodies


def test_print_tree_indented():
    """Twin of tests/test_treedump.py::test_print_tree_indented."""
    _, levels = _port_tree(random_cloud(300, seed=61), 4)
    s = print_tree_indented(levels, max_depth=2)
    assert s.startswith("[0:0] n=300")
    assert "[1:" in s and "[2:" in s
