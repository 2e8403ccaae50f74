"""Dense-grid build (nbody_tpu_torch/ops/bh_grid.py), the Morton group
rule (nbody_tpu_torch/ops/morton.py) and the fused path's sizing
heuristics against the JAX package on the same Morton-sorted bodies."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import barneshut as jb
from nbody_tpu.ops import bh_fused as jf
from nbody_tpu.ops import bh_grid as jg
from nbody_tpu_torch.ops import bh_fused as tf
from nbody_tpu_torch.ops import bh_persistent as tp
from nbody_tpu_torch.ops import bh_grid as tg
from nbody_tpu_torch.ops import morton as tm

DEPTH = 10


def _sorted_bodies(n: int, seed: int, clustered: bool = False):
    """Morton-sorted f32 positions, G·m and keys (numpy)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (n, 3))
    if clustered:  # half the bodies in one terminal cell
        pos[: n // 2] = rng.normal(0.3, 1e-4, (n // 2, 3))
    pos = pos.astype(np.float32)
    gm = rng.uniform(0.04, 1.0, n).astype(np.float32)
    perm, keys, _ = tm.morton_sort(torch.as_tensor(pos), DEPTH)
    perm = perm.numpy()
    return pos[perm], gm[perm], keys.numpy()[perm]


@pytest.mark.parametrize("n,seed,ld,clustered", [
    (500, 1, 2, False), (2000, 2, 3, False), (1500, 3, 3, True), (3, 4, 2, False),
])
def test_build_grid_matches_jax(n, seed, ld, clustered):
    pos_s, gm_s, keys_s = _sorted_bodies(n, seed, clustered)
    want = jg.build_grid(jnp.asarray(pos_s), jnp.asarray(gm_s),
                         jnp.asarray(keys_s), DEPTH, ld)
    got = tg.build_grid(torch.as_tensor(pos_s), torch.as_tensor(gm_s),
                        torch.as_tensor(keys_s), DEPTH, ld)
    assert got.total == want.total == tg.grid_offsets(ld)[ld + 1]
    for name in ("cnt", "start"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name))[0])
    for name in ("cx", "cy", "cz", "gm"):
        w = np.asarray(getattr(want, name))[0]
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=1e-6)
    assert got.cnt.dtype == got.start.dtype == torch.int32
    assert got.cx.dtype == torch.float32


def test_grid_offsets_match_jax():
    for ld in range(1, 9):
        assert tg.grid_offsets(ld) == jg.grid_offsets(ld)


@pytest.mark.parametrize("n,b,sl,keep", [
    (300, 128, 0, 0), (2000, 64, 1, 0), (5000, 128, 2, 0), (1500, 64, 1, 12),
])
def test_groups_match_jax(n, b, sl, keep):
    """group_bodies and compact_groups, exactly; `keep` > 0 trims occupied
    groups, which compact_groups must count.  The persistent layout sizes
    its groups by the same rule."""
    _, _, keys_s = _sorted_bodies(n, seed=n)
    jgroups = jb.group_bodies(jnp.asarray(keys_s), n, DEPTH, b, sl)
    tgroups = tm.group_bodies(torch.as_tensor(keys_s), n, DEPTH, b, sl)
    for g, w in zip(tgroups, jgroups):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = keep or tgroups[0].shape[0]
    jc = jb.compact_groups(*jgroups, keep)
    tc = tm.compact_groups(*tgroups, keep)
    for g, w in zip(tc, jc):
        np.testing.assert_array_equal(np.asarray(g.numpy()), np.asarray(w))
    # the fused path carries no slot arrays
    ranges = tm.compact_groups(tgroups[0], tgroups[1], None, None, keep)
    assert ranges[2] is None and ranges[3] is None
    np.testing.assert_array_equal(ranges[1].numpy(), np.asarray(jc[1]))
    if keep < tgroups[0].shape[0]:
        assert int(tc[4]) > 0
    assert tp._layout(n, b)[3] == tm.group_capacity(n, b, tm.auto_split_level(n, b))


@pytest.mark.parametrize("n", [1, 16, 17, 100, 1000, 32_769, 100_000,
                               1_000_000, 10_000_000, 20_000_000])
def test_auto_ld_matches_jax(n):
    assert tf.auto_ld(n) == jf.auto_ld(n)


@pytest.mark.parametrize("n,b", [(1, 1024), (300, 128), (2000, 64),
                                 (100_000, 1024), (1_000_000, 1024),
                                 (10_000_000, 1024), (1_000_000, 256)])
def test_auto_split_level_matches_jax(n, b):
    assert tm.auto_split_level(n, b) == jf.auto_split_level(n, b)


def test_auto_ld_bounds_of_the_jax_tests():
    """The cases of tests/test_bh_fused.py::test_auto_ld."""
    assert tf.auto_ld(100) == 2
    assert tf.auto_ld(100_000) == 5
    assert tf.auto_ld(1_000_000) == 6
    assert tf.auto_ld(20_000_000) == 6
