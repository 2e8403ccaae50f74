"""Morton keys (nbody_tpu_torch/ops/morton.py) and fixture generation
(nbody_tpu_torch/utils/fixtures.py) against the JAX package: keys and the
sort permutation must be equal, the fixture arrays bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import morton as jm
from nbody_tpu.utils import fixtures as jfix
from nbody_tpu_torch.ops import morton as tm
from nbody_tpu_torch.utils import fixtures as tfix


def _positions(case: str) -> np.ndarray:
    rng = np.random.default_rng(17)
    if case == "uniform":
        return rng.uniform(-2, 2, (1000, 3))
    if case == "ties":  # many bodies share a cell, and some a position
        pos = np.round(rng.uniform(-1, 1, (600, 3)), 1)
        return np.vstack([pos, pos[:50]])
    if case == "border":  # bodies on the root cube's faces clip into edge cells
        pos = rng.uniform(-1, 1, (300, 3))
        pos[:20] = rng.choice([-1.0, 1.0], (20, 3))
        pos[20:40, 0] = 1.0
        return pos
    # a tight cluster with far outliers: most keys tie at every depth
    return np.vstack([rng.normal(0, 1e-5, (400, 3)), rng.uniform(-50, 50, (10, 3))])


@pytest.mark.parametrize("case", ["uniform", "ties", "border", "cluster"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("depth", [10, 3])
def test_morton_sort_matches_jax(case, dtype, depth):
    np_dt = np.float32 if dtype == "f32" else np.float64
    pos = _positions(case).astype(np_dt)
    perm_j, keys_j, border_j = jm.morton_sort(jnp.asarray(pos), depth)
    perm_t, keys_t, border_t = tm.morton_sort(torch.as_tensor(pos), depth)
    assert border_t.dtype == (torch.float32 if dtype == "f32" else torch.float64)
    assert border_t.item() == float(border_j)
    np.testing.assert_array_equal(keys_t.numpy(), np.asarray(keys_j))
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    if case == "border":  # the +border/2 face lands in the last cell
        top = (1 << depth) - 1
        x_bits = keys_t[20:40].numpy()
        cell_x = sum(((x_bits >> (3 * b)) & 1) << b for b in range(depth))
        assert (cell_x == top).all()


def test_morton_border_override_matches_jax():
    pos = _positions("cluster").astype(np.float32)
    border = np.float32(1e-3)
    _, keys_j, _ = jm.morton_sort(jnp.asarray(pos), 10, border=jnp.asarray(border))
    _, keys_t, _ = tm.morton_sort(torch.as_tensor(pos), 10,
                                  border=torch.tensor(border))
    np.testing.assert_array_equal(keys_t.numpy(), np.asarray(keys_j))


@pytest.mark.parametrize("depth", [0, 11])
def test_morton_depth_out_of_range(depth):
    with pytest.raises(ValueError, match="depth must be in"):
        tm.morton_encode(torch.zeros((2, 3)), torch.tensor(1.0), depth)


@pytest.mark.parametrize("n,seed", [(1, 0), (1000, 0), (777, 5)])
def test_random_cloud_bit_identical(n, seed):
    np.testing.assert_array_equal(tfix.random_cloud(n, seed),
                                  jfix.random_cloud(n, seed))


@pytest.mark.parametrize("n,seed", [(10, 0), (700, 9)])
def test_plummer_cloud_bit_identical(n, seed):
    np.testing.assert_array_equal(tfix.plummer_cloud(n, seed),
                                  jfix.plummer_cloud(n, seed))


def test_write_fixture_same_bytes(tmp_path):
    arr = tfix.random_cloud(50, seed=3)
    tfix.write_fixture(tmp_path / "t.csv", arr)
    jfix.write_fixture(tmp_path / "j.csv", arr)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    back = np.loadtxt(tmp_path / "t.csv", delimiter=",")
    np.testing.assert_array_equal(back, arr)
