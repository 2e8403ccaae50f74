"""The port's outlier-robust fused Barnes-Hut hybrid
(nbody_tpu_torch/ops/bh_fused.py::barneshut_fused_robust and
bh_fused_df.py::barneshut_fused_robust_df) and its depth pricer
(ops/bh_autold.py), held against the JAX package's box and pricer and the
fp64 oracle.

The plain path runs here (K6's and K1's plain versions); the kernels take
the same inputs on the card (test_torch_cuda.py, chip_smoke.py).  JAX's
fused kernel is not run: in interpret mode it is what makes
test_bh_robust.py heavy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from nbody_tpu.ops import bh_autold as jax_autold
from nbody_tpu_torch.cli.main import main
from nbody_tpu_torch.ops import bh_autold
from nbody_tpu_torch.ops.bh_fused import (
    barneshut_fused,
    barneshut_fused_robust,
    fused_group_forces,
    fused_group_forces_reference,
    robust_box,
)
from nbody_tpu_torch.ops.bh_fused_df import barneshut_fused_robust_df
from nbody_tpu_torch.ops.cuda_exhaustive import (
    cuda_rect_accelerations,
    rect_accelerations_reference,
)
from nbody_tpu_torch.ops.morton import morton_encode
from nbody_tpu_torch.utils.fixtures import write_fixture
from tests.oracle import accel_exhaustive


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cloud_with_outliers(n=700, n_out=6, seed=0, r_out=300.0):
    """test_bh_robust.py:20-28's fixture."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (n, 3))
    mass = rng.uniform(0.04, 1.0, n)
    u = rng.normal(size=(n_out, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos[:n_out] = u * r_out * rng.uniform(0.5, 1.0, (n_out, 1))
    return pos, mass


def _plummer(n, seed=0, core=True, escapers=True):
    """test_autold.py:18-31's fixture."""
    rng = np.random.default_rng(seed)
    if core:
        u = rng.uniform(0.05, 0.95, n)
        r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    else:
        r = rng.uniform(0.4, 2.8, n)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = (r[:, None] * d).astype(np.float32)
    if escapers:
        pos[: max(4, n // 10000)] *= 1000.0
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return pos, mass


PLAIN = dict(group_forces=fused_group_forces_reference, rect_forces=rect_accelerations_reference)


@pytest.mark.parametrize("n,k", [(700, 32), (701, 32), (4000, 128), (5001, 0)])
def test_robust_box_matches_jax(n, k):
    """Centre, border and outlier set equal the JAX hybrid's jnp computation
    (bh_fused.py:1500-1508: jnp.median, lax.top_k) and both packages'
    numpy mirror, for even and odd n."""
    pos = _cloud_with_outliers(n=n, seed=n)[0].astype(np.float32)
    center, border, out_idx = robust_box(torch.as_tensor(pos), k)
    kk = min(k or max(128, n // 512), n - 1)
    p = jnp.asarray(pos)
    j_center = jnp.median(p, axis=0)
    vals, idx = lax.top_k(jnp.max(jnp.abs(p - j_center), axis=1), kk + 1)
    j_border = 2.0 * vals[kk] * 1.0001
    np.testing.assert_array_equal(center.numpy(), np.asarray(j_center))
    assert border.dtype == torch.float32
    assert border.item() == float(j_border)
    assert set(out_idx.tolist()) == set(np.asarray(idx[:kk]).tolist())
    for mirror in (bh_autold.robust_border_np, jax_autold.robust_border_np):
        c_np, b_np, o_np = mirror(pos, k)
        np.testing.assert_array_equal(c_np, center.numpy())
        assert b_np == pytest.approx(border.item(), rel=1e-6)
        assert set(o_np.tolist()) == set(out_idx.tolist())


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_robust_matches_oracle_with_outliers(dtype, seed):
    """The plain robust path within 0.02 of the fp64 oracle, for all bodies
    and for the outliers against their own force scale (test_bh_robust.py
    :31-48, in f32, and in f64 through the df form)."""
    pos_np, mass_np = _cloud_with_outliers(seed=seed)
    want = accel_exhaustive(pos_np, mass_np)
    tdt = torch.float64 if dtype == "f64" else torch.float32
    fn = barneshut_fused_robust_df if dtype == "f64" else barneshut_fused_robust
    acc, stats = fn(torch.as_tensor(pos_np, dtype=tdt), torch.as_tensor(mass_np, dtype=tdt),
                    theta=0.5, group_size=128, outlier_slots=32, ld=3, return_stats=True,
                    **PLAIN)
    assert acc.dtype == tdt
    assert int(stats["frontier_overflow"]) == 0
    acc = acc.numpy()
    assert np.abs(acc - want).max() / np.abs(want).max() < 0.02
    own = np.abs(want[:6]).max(axis=1)
    assert (np.abs(acc[:6] - want[:6]).max(axis=1) / own).max() < 0.02


def test_robust_shrinks_the_near_field():
    """The box is the point: with the escapers zero-massed outside it, the
    robust tree ships far fewer near bodies than the plain one at the same
    depth (test_bh_robust.py:51-79's mechanism, on the plain path)."""
    pos_np, mass_np = _cloud_with_outliers(n=2000, seed=2)
    p = torch.as_tensor(pos_np, dtype=torch.float32)
    m = torch.as_tensor(mass_np, dtype=torch.float32)
    kw = dict(theta=0.5, group_size=128, ld=5, return_stats=True,
              group_forces=fused_group_forces_reference)
    _, st_plain = barneshut_fused(p, m, **kw)
    _, st_rob = barneshut_fused_robust(p, m, outlier_slots=32,
                                       rect_forces=rect_accelerations_reference, **kw)
    assert int(st_plain["near_bodies"]) > 0.9 * 2000 * (2000 // 128)
    assert int(st_rob["near_bodies"]) < 0.75 * int(st_plain["near_bodies"])


def test_robust_matches_plain_on_clean_input():
    """No outliers: the top-K bodies move from the tree to the exact
    rectangle, within the θ envelope of the plain path (test_bh_robust.py
    :82-96)."""
    rng = np.random.default_rng(5)
    pos = torch.as_tensor(rng.uniform(-2, 2, (600, 3)), dtype=torch.float32)
    mass = torch.as_tensor(rng.uniform(0.04, 1.0, 600), dtype=torch.float32)
    a_plain = barneshut_fused(pos, mass, theta=0.5, group_size=128,
                              group_forces=fused_group_forces_reference)
    a_rob = barneshut_fused_robust(pos, mass, theta=0.5, group_size=128, outlier_slots=32,
                                   ld=3, **PLAIN)
    assert (a_plain - a_rob).abs().max().item() / a_plain.abs().max().item() < 0.02


def test_robust_kernel_wrappers_take_the_plain_path_on_cpu():
    """The default evaluators (the K6 and K1 wrappers) run their plain
    versions on CPU tensors and launch nothing; the result is the plain
    path's."""
    pos_np, mass_np = _cloud_with_outliers(n=300, seed=4)
    p = torch.as_tensor(pos_np, dtype=torch.float32)
    m = torch.as_tensor(mass_np, dtype=torch.float32)
    before = (fused_group_forces.launches, cuda_rect_accelerations.launches)
    got = barneshut_fused_robust(p, m, group_size=64, outlier_slots=16, ld=3)
    assert (fused_group_forces.launches, cuda_rect_accelerations.launches) == before
    assert torch.equal(got, barneshut_fused_robust(p, m, group_size=64, outlier_slots=16,
                                                   ld=3, **PLAIN))


def test_np_morton_matches_port_morton():
    rng = np.random.default_rng(3)
    pos = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
    border = 2.0 * float(np.max(np.abs(pos)))
    want = morton_encode(torch.as_tensor(pos), torch.tensor(border, dtype=torch.float32), 8)
    np.testing.assert_array_equal(bh_autold.np_morton_encode(pos, border, 8), want.numpy())


@pytest.fixture
def jax_costs(monkeypatch):
    """The port's unit costs set to the JAX package's, so the two pricers
    are held to the same arithmetic."""
    for name in ("NS_PER_SOURCE", "NS_PER_POP", "NS_PER_TABLE_NODE", "NS_PER_BUILD_NODE"):
        monkeypatch.setattr(bh_autold, name, getattr(jax_autold, name))


@pytest.mark.parametrize("persistent", [False, True])
def test_estimate_bh_costs_equals_jax(jax_costs, persistent):
    pos, mass = _plummer(20_000, seed=2)
    center, border, _ = bh_autold.robust_border_np(pos)
    kw = dict(border=border, center=center, depths=(4, 5, 6, 7, 8), persistent=persistent)
    assert bh_autold.estimate_bh_costs(pos, mass, **kw) == \
        jax_autold.estimate_bh_costs(pos, mass, **kw)


@pytest.mark.parametrize("core,robust", [(True, True), (False, True), (True, False)])
def test_choose_ld_equals_jax(jax_costs, core, robust):
    pos, mass = _plummer(30_000, seed=0, core=core)
    got = bh_autold.choose_ld(pos, mass, robust=robust, persistent=True)
    want = jax_autold.choose_ld(pos, mass, robust=robust, persistent=True)
    assert got[0] == want[0] and got[1] == want[1]


def test_choose_ld_cached_memo(tmp_path, monkeypatch):
    """The on-disk memo (test_autold.py:142-168's twin), in the port's own
    file: a rerun skips the probe; another config or input misses; the
    opt-out never reads it."""
    monkeypatch.setenv("NBODY_TPU_TORCH_CACHE", str(tmp_path))
    monkeypatch.delenv("NBODY_TPU_TORCH_NO_CACHE", raising=False)
    assert bh_autold.autold_cache_path() == str(tmp_path / "autold_cache.json")
    pos, mass = _plummer(40_000, seed=5)
    ld0, hit0 = bh_autold.choose_ld_cached(pos, mass, robust=True)
    assert not hit0 and (tmp_path / "autold_cache.json").exists()
    ld1, hit1 = bh_autold.choose_ld_cached(pos, mass, robust=True)
    assert hit1 and ld1 == ld0
    assert not bh_autold.choose_ld_cached(pos, mass, robust=True, theta=0.9)[1]
    pos2 = pos.copy()
    pos2[0] += 100.0
    assert not bh_autold.choose_ld_cached(pos2, mass, robust=True)[1]
    monkeypatch.setenv("NBODY_TPU_TORCH_NO_CACHE", "1")
    assert bh_autold.choose_ld_cached(pos, mass, robust=True) == (ld0, False)


def _outlier_csv(tmp_path, n=300, seed=3):
    pos, mass = _cloud_with_outliers(n=n, seed=seed)
    vel = np.random.default_rng(seed).uniform(-0.1, 0.1, (n, 3))
    path = tmp_path / "in.csv"
    write_fixture(str(path), np.concatenate([pos, vel, mass[:, None]], axis=1))
    return path, pos, vel, mass


def test_cli_auto_detects_outliers(tmp_path, capsys):
    """test_bh_robust.py:99-131's twin on --device cpu --bh-traversal fused:
    an outlier-laden input engages the hybrid (note, banner), a clean one
    does not."""
    src, *_ = _outlier_csv(tmp_path)
    out = tmp_path / "out.csv"
    argv = ["0", "0.2", "0.1", str(out), "--device", "cpu", "--algo", "barnes-hut",
            "--bh-traversal", "fused"]
    assert main([str(src), *argv]) == 0
    captured = capsys.readouterr()
    assert "enabling --bh-robust" in captured.err
    assert "backend: torch/fused/robust" in captured.out
    rng = np.random.default_rng(4)
    clean = tmp_path / "clean.csv"
    write_fixture(str(clean), np.concatenate([rng.uniform(-2, 2, (300, 3)),
                                              rng.uniform(-0.1, 0.1, (300, 3)),
                                              rng.uniform(0.04, 1, (300, 1))], axis=1))
    assert main([str(clean), *argv]) == 0
    captured = capsys.readouterr()
    assert "enabling --bh-robust" not in captured.err
    assert "robust" not in captured.out


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cli_robust_step_matches_plain_call(tmp_path, dtype):
    """The CLI's robust force is the hybrid with the flags' knobs: one KDK
    step against the same step by hand."""
    src, pos, vel, mass = _outlier_csv(tmp_path, n=400, seed=6)
    out = tmp_path / "o.csv"
    assert main([str(src), "0", "0.01", "0.01", str(out), "--device", "cpu", "--dtype",
                 dtype, "--algo", "barnes-hut", "--bh-traversal", "fused", "--bh-robust",
                 "on", "--bh-group-size", "64", "--bh-ld", "3"]) == 0
    tdt = torch.float64 if dtype == "f64" else torch.float32
    fn = barneshut_fused_robust_df if dtype == "f64" else barneshut_fused_robust
    acc = fn(torch.as_tensor(pos, dtype=tdt), torch.as_tensor(mass, dtype=tdt),
             group_size=64, ld=3, **PLAIN)
    dt = float(np.float32(0.01))
    p = torch.as_tensor(pos, dtype=tdt)
    if dtype == "f32":
        dt = np.float32(dt)
    want = p + (torch.as_tensor(vel, dtype=tdt) + acc * (dt * 0.5)) * dt
    rows = np.loadtxt(out, delimiter=",").reshape(2, 400, 5)
    np.testing.assert_allclose(rows[1, :, 1:4], want.numpy(), atol=1.1e-6, rtol=1e-7)


def test_cli_auto_prices_the_depth_of_a_robust_run(tmp_path, capsys, monkeypatch):
    """--algo auto on an outlier-dominated input, with the Barnes-Hut
    threshold lowered so a small input takes it: the hybrid engages, the
    depth pricer picks --bh-ld (cli/main.py:668-699) and caches the pick in
    the port's own file, and the run exits 0."""
    import nbody_tpu_torch.cli.main as cli

    monkeypatch.setattr(cli, "BH_AUTO_MIN_N", 100)
    monkeypatch.setenv("NBODY_TPU_TORCH_CACHE", str(tmp_path))
    monkeypatch.delenv("NBODY_TPU_TORCH_NO_CACHE", raising=False)
    src, *_ = _outlier_csv(tmp_path)
    argv = [str(src), "0", "0.1", "0.1", str(tmp_path / "o.csv"), "--device", "cpu",
            "--algo", "auto", "--bh-traversal", "fused"]
    assert main(argv) == 0
    captured = capsys.readouterr()
    assert "enabling --bh-robust on" in captured.err
    assert "data-adaptive grid depth picked --bh-ld" in captured.err
    assert "Algorithm: barnes-hut, backend: torch/fused/robust" in captured.out
    assert (tmp_path / "autold_cache.json").exists()
    assert main(argv) == 0
    assert "(cached probe;" in capsys.readouterr().err
