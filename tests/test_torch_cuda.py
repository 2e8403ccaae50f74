"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch twins.  Marked `cuda`; each test skips itself when no card is
present.  This file imports nothing of JAX, so on a machine without JAX it
runs without the shared conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.cli.main import PE_KERNEL_MIN_N, main
from nbody_tpu_torch.core.capacity import CapacityError
from nbody_tpu_torch.diag.energy import get_energy
from nbody_tpu_torch.io.csv import read_trajectory
from nbody_tpu_torch.ops import _cuda, barneshut, bh_fused, bh_fused_df, cuda_lists
from nbody_tpu_torch.ops.bh_grid import build_grid
from nbody_tpu_torch.ops.cuda_exhaustive import (
    cuda_accelerations,
    cuda_potential_energy,
    cuda_rect_accelerations,
    cuda_rect_accelerations_mxu,
    k1_split,
    potential_energy_reference,
    rect_accelerations_mxu_reference,
    rect_accelerations_reference,
)
from nbody_tpu_torch.ops.cuda_fp64 import (
    cuda_accelerations_f64,
    cuda_potential_energy_f64,
    cuda_rect_accelerations_f64,
)
from nbody_tpu_torch.utils.fixtures import plummer_cloud, random_cloud, write_fixture

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cloud(n, dev, seed=0):
    """Positions +-2 and masses 0.04-1, like conftest.random_cloud."""
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(-2.0, 2.0, (n, 3)), dtype=torch.float32)
    mass = torch.as_tensor(rng.uniform(0.04, 1.0, n), dtype=torch.float32)
    return pos.to(dev), mass.to(dev)


def _assert_f32_close(got, want):
    # the kernel's bound (test_pallas.py:25): rsqrt and summation order
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, atol=2e-5 * scale, rtol=2e-4)


@pytest.mark.parametrize("m,n", [(4096, 4096), (1000, 1000), (3001, 257),
                                 (1, 1)])
def test_allpairs_kernel_matches_twin(dev, m, n):
    pos, mass = _cloud(max(m, n), dev, seed=m)
    before = cuda_rect_accelerations.launches
    got = cuda_rect_accelerations(pos[:m], pos[:n], mass[:n], G=0.7)
    torch.cuda.synchronize()
    assert cuda_rect_accelerations.launches == before + 1
    _assert_f32_close(got, rect_accelerations_reference(
        pos[:m], pos[:n], mass[:n], G=0.7))


def test_allpairs_kernel_per_body(dev):
    pos, mass = _cloud(2000, dev, seed=3)
    e = torch.as_tensor(np.random.default_rng(4).uniform(1e-4, 1e-2, 2000),
                        dtype=torch.float32, device=dev)
    got = cuda_accelerations(pos, mass, eps2_per_body=e)
    want = rect_accelerations_reference(pos, pos, mass, eps2_i=e, eps2_all=e)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err < 5e-5, err


@pytest.mark.parametrize("m,n", [(5000, 3001), (100_003, 4_099), (1, 1)])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("per_body", [False, True])
def test_allpairs_kernel_split(dev, m, n, split, per_body):
    """K1 at each forced number of source slices a block against its plain
    version (the kernel's f32 bound, test_pallas.py:25), one launch counted,
    bit-identical reruns; the card's own pick (``k1_split`` on its SM
    count) gives the bits of that split forced."""
    pos, mass = _cloud(max(m, n), dev, seed=m + split)
    kw = {}
    if per_body:
        e = torch.as_tensor(np.random.default_rng(n).uniform(1e-4, 1e-2, max(m, n)),
                            dtype=torch.float32, device=dev)
        kw = dict(eps2_i=e[:m], eps2_all=e[:n])
    args = (pos[:m], pos[:n], mass[:n])
    before = cuda_rect_accelerations.launches
    got = cuda_rect_accelerations(*args, G=0.7, _split=split, **kw)
    torch.cuda.synchronize()
    assert cuda_rect_accelerations.launches == before + 1
    _assert_f32_close(got, rect_accelerations_reference(*args, G=0.7, **kw))
    assert torch.equal(cuda_rect_accelerations(*args, G=0.7, _split=split, **kw), got)
    if split == k1_split(m, _cuda.sm_count(dev)):
        assert torch.equal(cuda_rect_accelerations(*args, G=0.7, **kw), got)


@pytest.mark.parametrize("n", [20_000, 5_003])
def test_potential_kernel_matches_twin_and_fp64(dev, n):
    """K3 at an even and a ragged n, with coincident pairs in one tile and
    across row blocks and tiles (the r = 0 guard, through the rare branch)."""
    pos, mass = _cloud(n, dev, seed=7)
    pos[1] = pos[0]
    pos[n - 3] = pos[7]
    before = cuda_potential_energy.launches
    got = cuda_potential_energy(pos, mass, G=0.7)
    assert cuda_potential_energy.launches == before + 1
    twin = potential_energy_reference(pos, mass, G=0.7)
    _, pe64 = get_energy(pos.double(), torch.zeros_like(pos.double()),
                         mass.double(), G=0.7)
    assert got.item() == pytest.approx(twin.item(), rel=1e-5)
    assert got.item() == pytest.approx(pe64.item(), rel=1e-4)
    # no atomics: repeated runs are bit-identical
    assert cuda_potential_energy(pos, mass, G=0.7).item() == got.item()


def test_kernels_refuse_f64_on_the_card(dev):
    pos = torch.zeros((8, 3), dtype=torch.float64, device=dev)
    mass = torch.ones(8, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        cuda_accelerations(pos, mass)
    with pytest.raises(TypeError):
        cuda_potential_energy(pos, mass)


@pytest.mark.parametrize("n,b,ld,leaf_cap", [(20_000, 1024, 0, 64),
                                             (3001, 64, 3, 8),
                                             (5000, 256, 4, 16),
                                             (4000, 128, 8, 1)])
def test_bh_fused_kernel_matches_twin(dev, n, b, ld, leaf_cap):
    """K6 against its plain version on the same tables and groups: equal
    stats, K1's bound, bit-identical reruns, one evaluation of two kernel
    launches counted (the pricing pass, then the full kernel)."""
    pos, mass = _cloud(n, dev, seed=n)
    fi = bh_fused.prepare_fused(pos, mass, ld=ld, group_size=b)
    kw = dict(theta=0.5, eps2=0.01, leaf_cap=leaf_cap, ld=fi.ld, group_size=b)
    args = (fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq)
    before = (bh_fused.fused_group_forces.launches, bh_fused.fused_group_forces.evaluations)
    got, stats = bh_fused.fused_group_forces(*args, **kw)
    torch.cuda.synchronize()
    assert (bh_fused.fused_group_forces.launches,
            bh_fused.fused_group_forces.evaluations) == (before[0] + 2, before[1] + 1)
    want, want_stats = bh_fused.fused_group_forces_reference(*args, **kw)
    assert torch.equal(stats, want_stats)
    assert int(stats[:, bh_fused.S_FAR].sum()) > 0
    _assert_f32_close(got, want)
    again, _ = bh_fused.fused_group_forces(*args, **kw)
    assert torch.equal(got, again)


@pytest.mark.parametrize("case", ["one", "odd", "full1024", "longrun", "uniform"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bh_fused_stage_cuts_on_the_card(dev, case, dtype):
    """Every stage cut of K6 (f32, or the df mode) on the card: the stats
    of "full" in every cut but "none" (zero there), zero forces short of
    "full", the cut entry's "full" bit-identical to the production entry,
    the slots (f32) or pieces (df) taken heaviest first bit-identical to
    slot order; a
    1-body group, odd groups, 1,024-body groups, a near run longer than a
    ring stage, and 1,024-body uniform groups."""
    rng = np.random.default_rng(21)
    b, n = {"one": (16, 151), "odd": (97, 500), "full1024": (1024, 2500),
            "longrun": (256, 760), "uniform": (1024, 20_000)}[case]
    pos = rng.uniform(-2, 2, (n, 3))
    if case == "one":
        pos[-1] = 40.0
    if case == "longrun":
        pos[:700] = rng.normal(0, 1e-4, (700, 3))
    pos = torch.as_tensor(pos, dtype=dtype, device=dev)
    mass = torch.as_tensor(rng.uniform(0.1, 1, n), dtype=dtype, device=dev)
    fi = bh_fused.prepare_fused(pos, mass, ld=3 if n < 5000 else 0, group_size=b)
    kw = dict(theta=0.5, eps2=0.01, leaf_cap=8, ld=fi.ld, group_size=b,
              frontier_cap=bh_fused.FRONTIER_CAP)
    args = (fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq)
    prod, stats = bh_fused.kernel_forces(dtype, *args, **kw)
    for cut in bh_fused.CUTS:
        got, st = bh_fused.kernel_forces(dtype, *args, **kw, debug_mode=cut, cut_entry=True)
        if cut == "none":
            assert not st.any()
        else:
            assert torch.equal(st, stats), cut
        assert cut == "full" or not got.any(), cut
    assert torch.equal(got, prod)
    wrapper = (bh_fused.fused_group_forces if dtype == torch.float32
               else bh_fused_df.fused_group_forces_df)
    wrapped, st = wrapper(*args, **kw)  # heaviest first
    assert torch.equal(wrapped, prod) and torch.equal(st, stats)
    gcount = fi.gcount.cpu()
    assert {"one": (gcount == 1).any(), "odd": (gcount % 2 == 1).any(),
            "full1024": (gcount == 1024).sum() >= 2,
            "longrun": stats[:, bh_fused.S_NEAR].max() > 700,
            "uniform": (gcount == 1024).any()}[case]


def test_bh_fused_against_exact_forces(dev):
    pos, mass = _cloud(50_000, dev, seed=5)
    acc = bh_fused.barneshut_fused(pos, mass)
    exact = cuda_accelerations(pos, mass)
    err = ((acc - exact).abs().max() / exact.abs().max()).item()
    assert err < 0.02, err  # tests/test_bh_fused.py:51


def test_bh_fused_frontier_overflow_on_the_card(dev):
    pos, mass = _cloud(2000, dev, seed=21)
    with pytest.raises(CapacityError, match="--bh-frontier-cap"):
        bh_fused.check_fused(pos, mass, group_size=64, ld=4, leaf_cap=1,
                             frontier_cap=128)


def _bh1m_input(dev, seed=2**31 + 7):
    """(pos, vel, mass) of one input of the benchmark's bh-1m cells: the
    reference's uniform cloud of 1M bodies, drawn on the card."""
    from nbbench.gen import uniform_pool

    b = uniform_pool(10**6, 1, seed, torch.float32, dev)[0]
    return b[:, :3].contiguous(), b[:, 3:6].contiguous(), b[:, 6].contiguous()


@pytest.mark.parametrize("case", ["uniform1m", "robust", "df"])
def test_bh_probe_prices_a_full_evaluations_stats(dev, case):
    """The start-up probe on the card (the bh-1m input in f32, the robust
    fixture at ld 8, the bh-1m input in the df mode): the evaluator's
    pricing pass gives a full evaluation's stats lane by lane, and
    ``check_fused`` a full evaluation's stats dict, from one launch of K6
    (or K6 df) counted in ``.launches`` and not in ``.evaluations``."""
    robust, kw = case == "robust", {}
    if robust:
        pos, mass, _ = _plummer_with_escapers(1_000_000, dev)
        kw = dict(ld=8)
        t = bh_fused.robust_tree(pos, mass, ld=8)
        fi = bh_fused.prepare_fused(t.rel, t.mass, ld=t.ld, border=t.border)
    else:
        pos, _, mass = _bh1m_input(dev)
        if case == "df":
            pos, mass = pos.double(), mass.double()
            kw = dict(group_forces=bh_fused_df.fused_group_forces_df)
        fi = bh_fused.prepare_fused(pos, mass)
    wrapper = kw.get("group_forces", bh_fused.fused_group_forces)
    args = (fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq)
    gkw = dict(theta=0.5, eps2=0.01, leaf_cap=64, ld=fi.ld, group_size=fi.group_size,
               frontier_cap=bh_fused.FRONTIER_CAP)
    _, full = wrapper(*args, **gkw)
    assert torch.equal(wrapper.price(*args, **gkw), full)
    assert int(full[:, bh_fused.S_FAR].sum()) > 0
    fn = bh_fused.barneshut_fused_robust if robust else bh_fused.barneshut_fused
    _, want = fn(pos, mass, return_stats=True, **kw)
    before = (wrapper.launches, wrapper.evaluations)
    got = bh_fused.check_fused(pos, mass, robust=robust, **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.evaluations) == (before[0] + 1, before[1])
    assert got.keys() == want.keys()
    assert {k: int(v) for k, v in got.items()} == {k: int(v) for k, v in want.items()}


def test_bh1m_job_is_bit_equal_after_a_pricing_probe(dev):
    """A bh1m-f32 job (the probe, then 10 KDK steps at dt 1e-4) gives the
    same bits after the pricing probe as after a probe that evaluated the
    forces: the probe's forces were never used, and K6 has no atomics."""
    from functools import partial

    from nbody_tpu_torch.core.types import Bodies
    from nbody_tpu_torch.integrate.leapfrog import simulate

    pos, vel, mass = _bh1m_input(dev, seed=2**31 + 11)
    force = partial(bh_fused.barneshut_fused, G=1.0, softening_sq=0.01, theta=0.5)

    def job(probe):
        probe(pos, mass, **force.keywords)
        out = simulate(Bodies(pos.clone(), vel.clone(), mass.clone()), 10, 1e-4, force)
        return out.pos.cpu(), out.vel.cpu()

    def full_probe(pos, mass, **kw):
        _, stats = bh_fused.barneshut_fused(pos, mass, return_stats=True, **kw)
        assert int(stats["frontier_overflow"]) == int(stats["trimmed_groups"]) == 0

    priced, evaluated = job(bh_fused.check_fused), job(full_probe)
    assert torch.equal(priced[0], evaluated[0]) and torch.equal(priced[1], evaluated[1])


def _bits(t):
    """`t` with its floats read as integers of their width, so that equal
    means equal to the bit."""
    return {torch.float32: lambda: t.view(torch.int32),
            torch.float64: lambda: t.view(torch.int64)}.get(t.dtype, lambda: t)()


def _eager_layout(pos, mass, ld, border=None):
    """Every output of the one-shot set-up, its three stages run eagerly on
    the card: perm, the sorted positions, G·m, keys, the border, the six
    grid tables, gstart, gcount, src, bsq and trimmed."""
    split_level, keep = bh_fused.layout_sizing(pos.shape[0], 1024, ld, 0,
                                               pos.dtype == torch.float64, pos.device)
    sorted_ = bh_fused.sort_bodies(pos, mass, G=1.0, border=border)
    tree = build_grid(*sorted_[1:4], bh_fused.MORTON_DEPTH, ld)
    groups = bh_fused.group_inputs(*sorted_[1:], ld=ld, group_size=1024,
                                   split_level=split_level, keep=keep)
    return [*sorted_, *tree, *groups]


def _replayed_layout(pos, mass, ld, border=None):
    """The same outputs from ``prepare_fused`` (its set-up graphs), copied
    out of the graphs' memory."""
    fi = bh_fused.prepare_fused(pos, mass, G=1.0, ld=ld, border=border)
    (setup,) = [s for s in bh_fused._SETUPS.values() if s.tree is fi.tree]
    assert setup.graphs is not None and torch.equal(setup.sorted[0], fi.perm)
    return [t.clone() for t in (*setup.sorted, *fi.tree, fi.gstart, fi.gcount, fi.src,
                                fi.bsq, fi.trimmed)]


def _assert_bit_equal(got, want):
    assert len(got) == len(want) == 16
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(_bits(a), _bits(b)), i


def _setup_case(case, dev):
    """(pos, mass, ld, border) of a set-up test case: the bh-1m input, a
    clustered Plummer sphere, the bh-1m input in f64, and the robust box of
    a Plummer sphere with escapers at ld 8."""
    if case == "robust":
        pos, mass, _ = _plummer_with_escapers(1_000_000, dev)
        t = bh_fused.robust_tree(pos, mass, ld=8)
        return t.rel, t.mass, t.ld, t.border
    if case == "clustered":
        arr = plummer_cloud(300_000, seed=4)
        pos = torch.as_tensor(arr[:, :3], dtype=torch.float32, device=dev)
        mass = torch.as_tensor(arr[:, 6], dtype=torch.float32, device=dev)
    else:
        pos, _, mass = _bh1m_input(dev)
        if case == "f64":
            pos, mass = pos.double(), mass.double()
    return pos, mass, bh_fused.auto_ld(pos.shape[0]), None


@pytest.mark.parametrize("case", ["uniform1m", "clustered", "f64", "robust"])
def test_bh_setup_replay_is_bit_equal_to_eager(dev, case):
    """The set-up replayed from its CUDA graphs gives the eager stages'
    outputs to the bit, at the capture and at a later replay."""
    pos, mass, ld, border = _setup_case(case, dev)
    want = _eager_layout(pos, mass, ld, border)
    _assert_bit_equal(_replayed_layout(pos, mass, ld, border), want)
    _assert_bit_equal(_replayed_layout(pos, mass, ld, border), want)


@pytest.mark.parametrize("bordered", [False, True], ids=["cube", "border"])
def test_bh_setup_replays_give_each_input_its_own_layout(dev, bordered):
    """Two inputs of one layout, replayed back to back and then again: each
    replay gives its own input's layout, none a stale one."""
    inputs = []
    for seed in (2**31 + 3, 2**31 + 5):
        pos, _, mass = _bh1m_input(dev, seed)
        inputs.append((pos, mass, 2.5 * pos.abs().max() if bordered else None))
    ld = bh_fused.auto_ld(10**6)
    want = [_eager_layout(p, m, ld, b) for p, m, b in inputs]
    assert not torch.equal(want[0][0], want[1][0])
    for i in (0, 1, 0, 1):
        _assert_bit_equal(_replayed_layout(*inputs[i][:2], ld, inputs[i][2]), want[i])


def test_bh_setup_replay_does_not_sync(dev, monkeypatch):
    """After a layout's first set-up, its replay neither syncs nor asks the
    runtime for the free memory; a layout of another n reads it again."""
    pos, mass = _cloud(200_000, dev, seed=9)
    ld = bh_fused.auto_ld(200_000)
    bh_fused.prepare_fused(pos, mass, G=1.0, ld=ld)
    want = _eager_layout(pos, mass, ld)

    def no_query(*args, **kw):
        raise AssertionError("the budget was read again")

    monkeypatch.setattr(torch.cuda, "mem_get_info", no_query)
    before = bh_fused.prepare_fused.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        fi = bh_fused.prepare_fused(pos, mass, G=1.0, ld=ld)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bh_fused.prepare_fused.replays == before + 1
    assert torch.equal(fi.perm, want[0]) and torch.equal(fi.src, want[13])
    with pytest.raises(AssertionError, match="the budget was read again"):
        bh_fused.prepare_fused(pos[:-1], mass[:-1], G=1.0, ld=ld)


_BH1M_JOBS = """
import json
from functools import partial
import torch
from nbbench.gen import uniform_pool
from nbody_tpu_torch.core.types import Bodies
from nbody_tpu_torch.integrate.leapfrog import simulate
from nbody_tpu_torch.ops import bh_fused

dev = torch.device("cuda")
b = uniform_pool(10**6, 1, 2**31 + 13, torch.float32, dev)[0]
pos, vel, mass = b[:, :3].contiguous(), b[:, 3:6].contiguous(), b[:, 6].contiguous()
force = partial(bh_fused.barneshut_fused, G=1.0, softening_sq=0.01, theta=0.5)
queries, mem_get_info = [], torch.cuda.mem_get_info
torch.cuda.mem_get_info = lambda *a, **k: (queries.append(1), mem_get_info(*a, **k))[1]
counts = []
for _ in range(2):
    bh_fused.check_fused(pos, mass, **force.keywords)
    simulate(Bodies(pos.clone(), vel.clone(), mass.clone()), 10, 1e-4, force)
    counts.append([bh_fused.prepare_fused.captures, bh_fused.prepare_fused.replays,
                   len(queries)])
print(json.dumps(counts))
"""


def test_bh1m_jobs_capture_once_then_replay(dev):
    """In a fresh process, the first bh1m-f32 job (the probe, then 10 KDK
    steps: 12 set-ups) captures the set-up once and reads the budget once;
    the second job replays all 12 set-ups and reads nothing."""
    import json
    import pathlib
    import subprocess
    import sys

    run = subprocess.run([sys.executable, "-c", _BH1M_JOBS], capture_output=True, text=True,
                         cwd=pathlib.Path(__file__).resolve().parents[1], timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    first, second = json.loads(run.stdout.strip().splitlines()[-1])
    assert first == [1, 11, 1]
    assert second == [1, 23, 1]


def test_bh_fused_kernel_refuses_what_it_cannot_take(dev):
    pos, mass = _cloud(3000, dev, seed=1)
    with pytest.raises(ValueError, match="group_size"):
        bh_fused.barneshut_fused(pos, mass, group_size=2048)
    with pytest.raises(TypeError):
        bh_fused.barneshut_fused(pos.double(), mass.double())


# ---- the fp64 kernels: K4, K5 and K6's df mode ----------------------------


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _warp_pieces(gcount):
    """A df piece table that cuts every occupied group into one-warp
    pieces, in reverse order: a finer cut and another launch order than
    the production table's, which must give the same bits."""
    rows = [(g, b0, min(b0 + 32, c)) for g, c in enumerate(gcount.tolist())
            for b0 in range(0, c, 32)]
    return torch.tensor(rows[::-1], dtype=torch.int32, device=gcount.device)


@pytest.mark.parametrize("m,n", [(4096, 4096), (3001, 257), (1, 1)])
@pytest.mark.parametrize("split", [0, 1, 8])
def test_allpairs_f64_kernel_matches_plain(dev, m, n, split):
    """K4 within 1e-12 of its plain version (test_pallas_df.py:47), one
    launch counted, bit-identical reruns, at the split the card's SM count
    picks (0) and at 1 and 8 source slices a block."""
    pos, mass = (t.double() for t in _cloud(max(m, n), dev, seed=m + 1))
    pos[min(m, n) - 1] = pos[0]  # a coincident pair: the zero self-term
    before = cuda_rect_accelerations_f64.launches
    got = cuda_rect_accelerations_f64(pos[:m], pos[:n], mass[:n], G=0.7, _split=split)
    torch.cuda.synchronize()
    assert cuda_rect_accelerations_f64.launches == before + 1
    want = rect_accelerations_reference(pos[:m], pos[:n], mass[:n], G=0.7)
    assert got.dtype == torch.float64 and torch.isfinite(got).all()
    if m > 1:
        assert _rel(got, want) < 1e-12
    else:
        assert torch.equal(got, torch.zeros_like(got))
    assert torch.equal(cuda_rect_accelerations_f64(pos[:m], pos[:n], mass[:n], G=0.7,
                                                   _split=split), got)


@pytest.mark.parametrize("n", [20_000, 5_003])
def test_potential_f64_kernel_matches_plain(dev, n):
    """K5 at an even and a ragged n, with coincident pairs in one tile and
    across row blocks and tiles (the r = 0 guard, through the rare branch)."""
    pos, mass = (t.double() for t in _cloud(n, dev, seed=9))
    pos[1] = pos[0]
    pos[n - 3] = pos[7]
    before = cuda_potential_energy_f64.launches
    got = cuda_potential_energy_f64(pos, mass, G=0.7)
    assert cuda_potential_energy_f64.launches == before + 1
    want = potential_energy_reference(pos, mass, G=0.7)
    assert got.dtype == torch.float64
    assert got.item() == pytest.approx(want.item(), rel=1e-13)
    assert cuda_potential_energy_f64(pos, mass, G=0.7).item() == got.item()


def test_fp64_kernels_refuse_f32_on_the_card(dev):
    pos, mass = _cloud(8, dev)
    with pytest.raises(TypeError):
        cuda_accelerations_f64(pos, mass)
    with pytest.raises(TypeError):
        cuda_potential_energy_f64(pos, mass)


@pytest.mark.parametrize("n,b,ld,leaf_cap", [(20_000, 1024, 0, 64),
                                             (3001, 64, 3, 8),
                                             (5000, 256, 4, 16),
                                             (4000, 128, 8, 1)])
def test_bh_fused_df_kernel_matches_plain(dev, n, b, ld, leaf_cap):
    """K6's df mode against its plain version on the same f64 tables and
    groups: equal stats, 1e-12 of the force scale, bit-identical reruns,
    one evaluation of two kernel launches counted (the pricing pass, then
    the pieces heaviest first); the base pieces in slot order, and every
    group cut into one-warp pieces in reverse order, give the same bits."""
    pos, mass = (t.double() for t in _cloud(n, dev, seed=n))
    fi = bh_fused.prepare_fused(pos, mass, ld=ld, group_size=b)
    kw = dict(theta=0.5, eps2=0.01, leaf_cap=leaf_cap, ld=fi.ld, group_size=b)
    args = (fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq)
    wrapper = bh_fused_df.fused_group_forces_df
    before = (wrapper.launches, wrapper.evaluations)
    got, stats = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.evaluations) == (before[0] + 2, before[1] + 1)
    want, want_stats = bh_fused_df.fused_group_forces_df_reference(*args, **kw)
    assert torch.equal(stats, want_stats)
    assert int(stats[:, bh_fused.S_FAR].sum()) > 0
    assert got.dtype == torch.float64 and _rel(got, want) < 1e-12
    again, _ = wrapper(*args, **kw)
    assert torch.equal(got, again)
    kw["frontier_cap"] = bh_fused.FRONTIER_CAP
    for pieces in (None, _warp_pieces(fi.gcount)):
        cut, st = bh_fused.kernel_forces(torch.float64, *args, **kw, pieces=pieces)
        assert torch.equal(cut, got) and torch.equal(st, stats)


def test_bh_fused_df_against_exact_forces(dev):
    pos, mass = (t.double() for t in _cloud(50_000, dev, seed=5))
    acc = bh_fused_df.barneshut_fused_df(pos, mass)
    assert _rel(acc, cuda_accelerations_f64(pos, mass)) < 0.02  # test_bh_fused_df.py:226


@pytest.mark.parametrize("algo,n", [("exhaustive", 60_000), ("barnes-hut", 5000),
                                    ("auto", 40_000)])
def test_cli_f64_runs_through_the_fp64_kernels(dev, tmp_path, capsys, algo, n):
    """--dtype f64 on the card: K4 (and K5 at n >= 50,000) for the
    all-pairs run, K6's df mode for Barnes-Hut; no f32 kernel launches."""
    src, out = tmp_path / "in.csv", tmp_path / "o.csv"
    write_fixture(str(src), random_cloud(n, seed=n))
    counters = (cuda_rect_accelerations, cuda_potential_energy,
                bh_fused.fused_group_forces, cuda_rect_accelerations_f64,
                cuda_potential_energy_f64, bh_fused_df.fused_group_forces_df)
    for c in counters:
        c.launches = 0
    assert main([str(src), "0", "0.002", "0.001", str(out), "--dtype", "f64",
                 "--algo", algo, "--energy"]) == 0  # 2 steps
    k1, k3, k6, k4, k5, k6df = (c.launches for c in counters)
    assert (k1, k3, k6) == (0, 0, 0)
    if algo == "exhaustive":
        assert (k4, k5, k6df) == (3, 2, 0)
    else:  # the capacity probe's pricing launch, then 3 evaluations of two
        assert (k4, k5, k6df) == (0, 2 if n >= PE_KERNEL_MIN_N else 0, 7)
    assert "backend: cuda" in capsys.readouterr().out
    rows, n_out = read_trajectory(str(out))
    assert n_out == n and np.isfinite(rows).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_group_lists_kernel_matches_plain(dev, dtype):
    """K7 against its plain version on the flat traversal's own lists at
    100k bodies (B 1792, 120 group slots): K1's bound in f32, 1e-12 of the
    force scale in fp64; one launch counted; reruns bit-identical."""
    pos, mass = _cloud(100_000, dev, seed=11)
    gl = barneshut.group_lists(pos.to(dtype), mass.to(dtype))
    assert not bool((gl.lengths == 0).any())
    wrapper = cuda_lists.eval_lists_f64 if dtype == torch.float64 else cuda_lists.eval_lists
    before = wrapper.launches
    got = wrapper(gl.pg, gl.lists, gl.lengths, eps2=0.01)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = cuda_lists.eval_lists_reference(gl.pg, gl.lists, gl.lengths, eps2=0.01)
    if dtype == torch.float32:
        _assert_f32_close(got, want)
    else:
        assert _rel(got, want) <= 1e-12
    assert torch.equal(wrapper(gl.pg, gl.lists, gl.lengths, eps2=0.01), got)


@pytest.mark.parametrize("dtype,split", [
    *(pytest.param(torch.float64, s, id=str(s)) for s in (1, 2, 4, 8)),
    *(pytest.param(torch.float32, s, id=f"f32-{s}") for s in (1, 2, 4, 8))])
def test_group_lists_f64_kernel_split(dev, dtype, split):
    """K7's entries (the fp64 one, and the f32 one, ids f32-*) at each
    forced number of list slices a block, on the flat traversal's lists at
    20k bodies with B = 1,000 (a partial last chunk of slots at every
    split): K1's bound in f32, 1e-12 of the force scale in fp64, of the
    plain version; pad slots equal to slot 0, bit-identical reruns; the
    card's own pick (``k7_split`` on its SM count) gives the bits of that
    split forced."""
    pos, mass = _cloud(20_000, dev, seed=13)
    gl = barneshut.group_lists(pos.to(dtype), mass.to(dtype), group_size=1000)
    g, b, _ = gl.pg.shape
    wrapper = cuda_lists.eval_lists_f64 if dtype == torch.float64 else cuda_lists.eval_lists
    before = wrapper.launches
    got = wrapper(gl.pg, gl.lists, gl.lengths, eps2=0.01, _split=split)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = cuda_lists.eval_lists_reference(gl.pg, gl.lists, gl.lengths, eps2=0.01)
    if dtype == torch.float32:
        _assert_f32_close(got, want)
    else:
        assert _rel(got, want) <= 1e-12
    pad = ~gl.group_valid
    assert bool(pad.any())
    assert torch.equal(got[pad], got[:, :1].expand(g, b, 3)[pad])
    assert torch.equal(wrapper(gl.pg, gl.lists, gl.lengths, eps2=0.01, _split=split), got)
    if split == cuda_lists.k7_split(g, b, _cuda.sm_count(dev)):
        assert torch.equal(wrapper(gl.pg, gl.lists, gl.lengths, eps2=0.01), got)


def test_group_lists_kernel_refuses_f64_in_the_f32_entry(dev):
    pg = torch.zeros((2, 4, 3), dtype=torch.float64, device=dev)
    lists = torch.zeros((2, 8, 4), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        cuda_lists.eval_lists(pg, lists, torch.ones(2, dtype=torch.int32, device=dev),
                              eps2=0.01)


@pytest.mark.parametrize("traversal", ["flat", "padded"])
def test_list_path_against_exact_forces(dev, traversal):
    """The list path through K7 at 100k within 0.02 of K1's exact forces
    (the Barnes-Hut bound, test_bh_fused.py:51).  The padded traversal's
    default frontier (1024) is too narrow at 100k uniform bodies (1280)."""
    pos, mass = _cloud(100_000, dev, seed=12)
    before = cuda_lists.eval_lists.launches
    acc, stats = barneshut.barneshut_accelerations(pos, mass, traversal=traversal,
                                                   frontier_size=2048, return_stats=True)
    assert cuda_lists.eval_lists.launches == before + 1
    assert not stats.overflowed()
    assert _rel(acc, cuda_accelerations(pos, mass)) < 0.02


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cli_flat_runs_through_k7(dev, tmp_path, capsys, dtype):
    """--bh-traversal flat on the card: K7 (the probe, then 3 evaluations
    over 2 steps) in the run's dtype, and neither K6 nor K1."""
    src, out = tmp_path / "in.csv", tmp_path / "o.csv"
    write_fixture(str(src), random_cloud(5000, seed=3))
    counters = (cuda_lists.eval_lists, cuda_lists.eval_lists_f64,
                bh_fused.fused_group_forces, bh_fused_df.fused_group_forces_df,
                cuda_rect_accelerations, cuda_rect_accelerations_f64)
    for c in counters:
        c.launches = 0
    assert main([str(src), "0", "0.002", "0.001", str(out), "--dtype", dtype,
                 "--algo", "barnes-hut", "--bh-traversal", "flat"]) == 0
    k7, k7_64, *others = (c.launches for c in counters)
    assert (k7, k7_64) == ((4, 0) if dtype == "f32" else (0, 4))
    assert others == [0, 0, 0, 0]
    assert f"backend: cuda, dtype: {dtype}" in capsys.readouterr().out
    rows, n_out = read_trajectory(str(out))
    assert n_out == 5000 and np.isfinite(rows).all()


# ---- K2, the tensor-core j-sum, and the robust hybrid ---------------------


@pytest.mark.parametrize("m,n,per_body", [(4096, 4096, False), (3001, 257, False),
                                          (1, 9, False), (2000, 2000, True),
                                          (256, 512, False), (257, 513, False),
                                          (65, 65, True)])
def test_allpairs_mma_kernel_matches_plain(dev, m, n, per_body):
    """K2 within K1's bound of its plain version and of K1, one launch
    counted, bit-identical reruns; unaligned shapes check the fragment
    layout, and shapes on and one past the tile edges (a block's 256
    targets, a tile's 512 sources, a warp's 64 rows and a tensor-core
    chain's 64 sources); per-body ε² in [1e-3, 1e-2]."""
    pos, mass = _cloud(m + n, dev, seed=m + n)
    # targets apart from sources: at these force scales a softened
    # self-term's weight G m / eps^3, which the W @ [x 1] - x * sum(w) form
    # cancels in 3xTF32, sets the error (chip_smoke.py [24] holds K2 with
    # self-terms to K1's bound at 100k)
    pi, pj, mj = pos[:m], pos[m:], mass[m:]
    kw = {}
    if per_body:
        e = torch.as_tensor(np.random.default_rng(m).uniform(1e-3, 1e-2, m + n),
                            dtype=torch.float32, device=dev)
        kw = dict(eps2_i=e[:m].contiguous(), eps2_all=e[m:].contiguous())
    before = cuda_rect_accelerations_mxu.launches
    got = cuda_rect_accelerations(pi, pj, mj, G=0.7, use_mxu=True, **kw)
    torch.cuda.synchronize()
    assert cuda_rect_accelerations_mxu.launches == before + 1
    _assert_f32_close(got, rect_accelerations_mxu_reference(pi, pj, mj, G=0.7, **kw))
    _assert_f32_close(got, cuda_rect_accelerations(pi, pj, mj, G=0.7, **kw))
    assert torch.equal(got, cuda_rect_accelerations(pi, pj, mj, G=0.7, use_mxu=True, **kw))


@pytest.mark.parametrize("per_body", [False, True])
def test_allpairs_mma_kernel_off_origin(dev, per_body):
    """K2 on a cloud offset by (8, -8, 8) from the origin (chip_smoke.py
    [24]'s offset), 3,001 targets x 4,099 other sources: within K1's bound
    of K1 and of K1's plain version."""
    pos, mass = _cloud(7100, dev, seed=8)
    pos = pos + torch.tensor([8.0, -8.0, 8.0], device=dev)
    pi, pj, mj = pos[:3001].contiguous(), pos[3001:].contiguous(), mass[3001:].contiguous()
    kw = {}
    if per_body:
        e = torch.as_tensor(np.random.default_rng(8).uniform(1e-3, 1e-2, 7100),
                            dtype=torch.float32, device=dev)
        kw = dict(eps2_i=e[:3001].contiguous(), eps2_all=e[3001:].contiguous())
    got = cuda_rect_accelerations(pi, pj, mj, G=0.7, use_mxu=True, **kw)
    _assert_f32_close(got, cuda_rect_accelerations(pi, pj, mj, G=0.7, **kw))
    _assert_f32_close(got, rect_accelerations_reference(pi, pj, mj, G=0.7, **kw))


def _plummer_with_escapers(n, dev, dtype=torch.float32):
    """plummer_cloud with 8 bodies flung out to r 300-1000 (the manner of
    test_bh_robust.py:20-28)."""
    arr = plummer_cloud(n, seed=0)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(8, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    arr[:8, :3] = u * rng.uniform(300.0, 1000.0, (8, 1))
    return (torch.as_tensor(arr[:, :3], dtype=dtype, device=dev),
            torch.as_tensor(arr[:, 6], dtype=dtype, device=dev), arr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_robust_against_exact_forces(dev, dtype):
    """The robust hybrid through K6 (or its df mode) and K1 (or K4), one
    evaluation of each (K6 is two launches in both modes: the pricing pass
    and the full kernel), within 0.02 of exact forces, the escapers within
    0.02 of their own force scale."""
    from nbody_tpu_torch.ops.bh_fused import barneshut_fused_robust
    from nbody_tpu_torch.ops.bh_fused_df import barneshut_fused_robust_df

    pos, mass, _ = _plummer_with_escapers(50_000, dev, dtype)
    f64 = dtype == torch.float64
    counters = ((bh_fused_df.fused_group_forces_df, cuda_rect_accelerations_f64) if f64
                else (bh_fused.fused_group_forces, cuda_rect_accelerations))
    before = [c.launches for c in counters]
    fn = barneshut_fused_robust_df if f64 else barneshut_fused_robust
    evals = (bh_fused.fused_group_forces.evaluations,
             bh_fused_df.fused_group_forces_df.evaluations)
    acc = fn(pos, mass, G=1.0)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [before[0] + 2, before[1] + 1]
    assert (bh_fused.fused_group_forces.evaluations,
            bh_fused_df.fused_group_forces_df.evaluations) == (
                evals[0] + (0 if f64 else 1), evals[1] + (1 if f64 else 0))
    exact = (cuda_accelerations_f64 if f64 else cuda_accelerations)(pos, mass, G=1.0)
    assert _rel(acc, exact) < 0.02
    own = exact[:8].abs().amax(dim=1)
    assert ((acc[:8] - exact[:8]).abs().amax(dim=1) / own).max().item() < 0.02


def test_cli_robust_runs_through_k6_and_k1(dev, tmp_path, capsys):
    """--algo auto on an outlier-dominated 40k cloud: the robust hybrid
    (note, banner), K6's pricing launch for the probe (no K1 rectangle),
    then 3 evaluations (K6 two launches each, K1 one)."""
    _, _, arr = _plummer_with_escapers(40_000, "cpu")
    src, out = tmp_path / "in.csv", tmp_path / "o.csv"
    write_fixture(str(src), arr)
    counters = (bh_fused.fused_group_forces, cuda_rect_accelerations,
                cuda_rect_accelerations_mxu)
    for c in counters:
        c.launches = 0
    bh_fused.fused_group_forces.evaluations = 0
    assert main([str(src), "0", "0.002", "0.001", str(out), "--algo", "auto",
                 "--bh-ld", "6"]) == 0
    assert [c.launches for c in counters] == [7, 3, 0]
    assert bh_fused.fused_group_forces.evaluations == 3
    captured = capsys.readouterr()
    assert "enabling --bh-robust on" in captured.err
    assert "backend: cuda/fused/robust, dtype: f32" in captured.out


@pytest.mark.parametrize("robust_slots,ld", [(0, 0), (128, 7)])
def test_persistent_state_forces_match_plain(dev, robust_slots, ld):
    """state_forces on the persistent layout after drift-only steps (a
    stale partition, whose cell spans cover pad slots) through K6 (and K1
    in robust mode) against the plain versions on the same state: the f32
    kernel bound on the real slots, equal stats, zero on the pads, and
    reruns bit-identical."""
    from nbody_tpu_torch.ops import bh_persistent as bp

    if robust_slots:
        pos, mass, _ = _plummer_with_escapers(60_000, dev)
    else:
        pos, mass = _cloud(60_000, dev, seed=3)
    vel = torch.randn_like(pos) * 0.5
    st = bp.init_state(pos, vel, mass, G=1.0, group_size=1024,
                       robust_slots=robust_slots, ld=ld or None)
    for _ in range(3):
        st.src[:, :3] += st.vel * 1e-3
    kw = dict(theta=0.5, softening_sq=0.01, leaf_cap=64)
    before = (bh_fused.fused_group_forces.launches, cuda_rect_accelerations.launches)
    acc, stats = bp.state_forces(st, **kw)
    torch.cuda.synchronize()
    assert (bh_fused.fused_group_forces.launches - before[0],
            cuda_rect_accelerations.launches - before[1]) == (2, 1 if robust_slots else 0)
    want, stats_p = bp.state_forces(st, **kw, group_forces=bh_fused.fused_group_forces_reference,
                                    rect_forces=rect_accelerations_reference)
    _assert_f32_close(acc[st.real], want[st.real])
    assert torch.equal(stats, stats_p)
    assert int(stats[:, bh_fused.S_OVF].max()) == 0 and int(stats[:, bh_fused.S_FAR].sum()) > 0
    if not robust_slots:
        assert not acc[~st.valid].any()
    again, stats2 = bp.state_forces(st, **kw)
    assert torch.equal(again, acc) and torch.equal(stats2, stats)


def test_cli_persistent_runs_through_k6(dev, tmp_path, capsys):
    """--resort-every 2 on a 40k cloud: the persistent banner, the probe
    (K6's pricing launch) and 4 persistent evaluations (K6 two launches
    each) over 3 steps, and the frames of --resort-every 1 within 1e-5."""
    arr = random_cloud(40_000, seed=6)
    src = tmp_path / "in.csv"
    write_fixture(str(src), arr)
    frames = {}
    for k in (2, 1):
        out = tmp_path / f"o{k}.csv"
        bh_fused.fused_group_forces.launches = bh_fused.fused_group_forces.evaluations = 0
        assert main([str(src), "0", "0.003", "0.001", str(out), "--algo", "auto",
                     "--resort-every", str(k), "--bh-robust", "off"]) == 0
        assert bh_fused.fused_group_forces.evaluations == 4
        assert bh_fused.fused_group_forces.launches == 9
        assert "backend: cuda/fused/persistent, dtype: f32" in capsys.readouterr().out
        rows, n = read_trajectory(out)
        frames[k] = rows.reshape(-1, n, 5)
    np.testing.assert_allclose(frames[2], frames[1], atol=1e-5, rtol=0)
