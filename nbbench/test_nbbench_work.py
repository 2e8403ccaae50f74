"""The work counts against the program's own counts of the same work."""

import pytest
import torch

from nbbench import gen, peaks
from nbbench.work import allpairs, k6

H100 = "NVIDIA H100 80GB HBM3"


def test_allpairs_bounds_are_chip_smokes():
    """19 n^2 operations at 67 (f32) and 34 (fp64) TFLOP/s at 100k: the
    bounds chip_smoke.py states for K1 and K4, 2.8358 and 5.5882 ms."""
    n = 100_000
    assert allpairs.bound_seconds(n, n, peaks.peak(H100, "f32")) * 1e3 == pytest.approx(
        2.8358, abs=5e-5)
    assert allpairs.bound_seconds(n, n, peaks.peak(H100, "f64")) * 1e3 == pytest.approx(
        5.5882, abs=5e-5)
    assert peaks.peak("some other card", "f32") is None


@pytest.mark.parametrize("n,ld,b,seed", [(3000, 3, 128, 1), (20000, 4, 256, 2),
                                         (20000, 3, 1024, 3)])
def test_k6_count_is_the_ports_real_interactions(n, ld, b, seed):
    """The frozen group-MAC count equals the bodies x staged sources that
    the port's plain twin of K6 reports in its stats lanes (near bodies
    plus far cells, each group's real bodies only)."""
    from nbody_tpu_torch.ops import bh_fused

    pos, _, mass = gen.make_pool("uniform", n, 1, seed, "f32", torch.device("cpu"))[0]
    config = {"G": 1.0, "theta": 0.5, "ld": ld, "group_size": b, "leaf_cap": 64}
    fi = bh_fused.prepare_fused(pos, mass, G=1.0, ld=ld, group_size=b)
    _, stats = bh_fused.fused_group_forces_reference(
        fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq, theta=0.5, eps2=0.01, leaf_cap=64,
        ld=ld, group_size=b, debug_mode="pops")
    port = int((fi.gcount.long() * stats[:, bh_fused.S_SRC].long()).sum())
    assert k6.interactions(config, pos, mass) == port
