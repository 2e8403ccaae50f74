"""The PyTorch port's CLI (nbody_tpu_torch/cli/main.py) on the CPU, held
against the reference golden output and the JAX CLI."""

import os
import re

import numpy as np
import pytest
import torch

from conftest import DATA_DIR, random_cloud
from nbody_tpu.cli.main import main as jax_main
from nbody_tpu_torch.cli.main import (
    BH_AUTO_MIN_N,
    build_force_fn,
    main,
    read_softening_per_body,
    resolve_algo,
    resolve_backend,
    resolve_traversal,
)
from nbody_tpu_torch.core.types import Bodies
from nbody_tpu_torch.io.csv import read_bodies, read_trajectory
from nbody_tpu_torch.ops import barneshut, bh_fused, cuda_lists
from nbody_tpu_torch.ops.bh_fused import barneshut_fused
from nbody_tpu_torch.ops.bh_fused_df import barneshut_fused_df, fused_group_forces_df
from nbody_tpu_torch.ops.cuda_exhaustive import cuda_accelerations
from nbody_tpu_torch.ops.cuda_fp64 import cuda_accelerations_f64
from nbody_tpu_torch.ops.exhaustive import exhaustive_accelerations
from nbody_tpu_torch.utils.fixtures import write_fixture


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TEN = os.path.join(DATA_DIR, "10_bodies.csv")
GOLDEN = os.path.join(DATA_DIR, "golden_exh_10bodies_0_10_0.1.csv")
CPU64 = ["--device", "cpu", "--dtype", "f64", "--backend", "torch"]


def test_cli_matches_golden_and_jax_cli(tmp_path, capsys):
    """f64 frames within 1.1e-5 of the reference binary's %lf output and of
    the JAX CLI's output on the same run."""
    out = tmp_path / "torch.csv"
    assert main([TEN, "0", "10", "0.1", str(out), *CPU64, "--energy"]) == 0
    text = capsys.readouterr().out
    assert "time steps: 100, ents: 10, G: 1" in text
    assert "backend: torch, dtype: f64, device: cpu" in text
    assert "Pair interactions/sec:" in text
    assert "Relative energy drift:" in text

    jout = tmp_path / "jax.csv"
    assert jax_main([TEN, "0", "10", "0.1", str(jout), "--dtype", "f64",
                     "--backend", "jnp"]) == 0

    rows, n = read_trajectory(out)
    assert n == 10 and rows.shape == (101 * 10, 5)
    golden = np.loadtxt(GOLDEN, delimiter=",")
    jrows = np.loadtxt(jout, delimiter=",")
    np.testing.assert_allclose(rows, golden, atol=1.1e-5, rtol=0)
    np.testing.assert_allclose(rows, jrows, atol=1.1e-5, rtol=0)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_cli_write_every(tmp_path, k):
    full, strided = tmp_path / "full.csv", tmp_path / "strided.csv"
    args = ["0", "2", "0.1", *CPU64, "--chunk-steps", "4"]
    assert main([TEN, args[0], args[1], args[2], str(full), *args[3:]]) == 0
    assert main([TEN, args[0], args[1], args[2], str(strided), *args[3:],
                 "--write-every", str(k)]) == 0
    frames = np.loadtxt(full, delimiter=",").reshape(-1, 10, 5)
    assert frames.shape[0] == 21
    got = np.loadtxt(strided, delimiter=",").reshape(-1, 10, 5)
    np.testing.assert_array_equal(got, frames[::k])


def test_cli_no_output(tmp_path):
    out = tmp_path / "none.csv"
    assert main([TEN, "0", "1", "0.1", str(out), *CPU64, "--no-output"]) == 0
    assert not out.exists()


def test_cli_f32_cpu_default_backend(tmp_path, capsys):
    out = tmp_path / "f32.csv"
    assert main([TEN, "0", "1", "0.1", str(out), "--device", "cpu"]) == 0
    assert "backend: torch, dtype: f32, device: cpu" in capsys.readouterr().out
    rows, _ = read_trajectory(out)
    golden = np.loadtxt(GOLDEN, delimiter=",")[: rows.shape[0]]
    # f32 over 10 steps: well inside the golden file's %lf resolution
    np.testing.assert_allclose(rows, golden, atol=1.1e-5, rtol=0)


def test_cli_malformed_csv(tmp_path, capsys):
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2,3,4,5,6,7\n1,2,3\n")
    assert main([str(bad), "0", "1", "0.1", str(tmp_path / "o.csv"),
                 "--device", "cpu"]) == 1
    assert "file is not well formed" in capsys.readouterr().err


def test_cli_zero_dt(tmp_path, capsys):
    assert main([TEN, "0", "1", "0", str(tmp_path / "o.csv"),
                 "--device", "cpu"]) == 2
    assert "delta_time must be nonzero" in capsys.readouterr().err


def test_cli_end_before_start_runs_zero_steps(tmp_path):
    out = tmp_path / "o.csv"
    assert main([TEN, "1", "0", "0.1", str(out), *CPU64]) == 0
    assert np.loadtxt(out, delimiter=",").shape == (10, 5)


@pytest.mark.parametrize("algo", ["barnes-hut", "auto"])
def test_cli_refuses_unported_algo(tmp_path, capsys, algo):
    """The Barnes-Hut runs that once exited 2 as not ported now run:
    --timers on the list-based path (K7's pipeline), and the persistent
    layout under the robust hybrid of the fused traversal, here on the
    Barnes-Hut side of --algo auto (> 32,768 bodies; no steps, so the run
    is the state's build, its first evaluation and the final frame)."""
    if algo == "barnes-hut":
        src, flags, said = TEN, ["--bh-traversal", "flat", "--timers", "--bh-list-size",
                                 "1024"], "traverse"
        window = ["0", "0.1", "0.1"]
    else:
        src = tmp_path / "big.csv"
        write_fixture(src, random_cloud(BH_AUTO_MIN_N + 1, seed=1))
        flags = ["--bh-robust", "on", "--bh-traversal", "fused", "--resort-every", "4",
                 "--bh-ld", "6", "--bh-group-size", "64", "--no-capacity-check"]
        said, window = "backend: torch/fused/robust/persistent", ["0", "0", "0.1"]
    out = tmp_path / "o.csv"
    assert main([str(src), *window, str(out), "--device", "cpu", "--algo", algo,
                 *flags]) == 0
    captured = capsys.readouterr()
    assert said in captured.out and "not ported" not in captured.err
    assert out.exists()


def test_cli_auto_runs_exhaustive_at_10_bodies(tmp_path, capsys):
    """--algo auto at n <= 32,768 is exhaustive (cli/main.py:356-357)."""
    out = tmp_path / "o.csv"
    assert main([TEN, "0", "10", "0.1", str(out), *CPU64, "--algo", "auto"]) == 0
    assert "Algorithm: exhaustive, backend: torch, dtype: f64" in capsys.readouterr().out
    golden = np.loadtxt(GOLDEN, delimiter=",")
    np.testing.assert_allclose(np.loadtxt(out, delimiter=","), golden,
                               atol=1.1e-5, rtol=0)


def test_cli_barnes_hut_at_10_bodies(tmp_path, capsys):
    """At 10 bodies every cell is near (ld 2, and the group box covers every
    centre of mass), so the fused path is exact: it matches the all-pairs
    golden trajectory within its %lf resolution."""
    out = tmp_path / "o.csv"
    assert main([TEN, "0", "10", "0.1", str(out), *CPU64,
                 "--algo", "barnes-hut", "--bh-traversal", "fused", "--energy"]) == 0
    text = capsys.readouterr().out
    assert "Algorithm: barnes-hut, backend: torch/fused, dtype: f64" in text
    assert "Pair interactions/sec" not in text  # exhaustive only (:1196)
    assert "Relative energy drift:" in text
    golden = np.loadtxt(GOLDEN, delimiter=",")
    np.testing.assert_allclose(np.loadtxt(out, delimiter=","), golden,
                               atol=1.1e-5, rtol=0)


def test_cli_barnes_hut_f32_matches_plain_call(tmp_path):
    """The CLI's Barnes-Hut force is barneshut_fused with the flags' knobs:
    one step of a 2,000-body cloud against the same KDK step by hand."""
    arr = random_cloud(2000, seed=4)
    src, out = tmp_path / "in.csv", tmp_path / "o.csv"
    write_fixture(src, arr)
    assert main([str(src), "0", "0.01", "0.01", str(out), "--device", "cpu",
                 "--algo", "barnes-hut", "--bh-traversal", "fused",
                 "--bh-group-size", "64", "--bh-leaf-cap", "8", "--bh-ld", "3",
                 "--theta", "0.6"]) == 0
    b = Bodies.from_numpy(read_bodies(str(src)), dtype=torch.float32)
    kw = dict(theta=0.6, group_size=64, leaf_cap=8, ld=3)
    acc = barneshut_fused(b.pos, b.mass, **kw)
    dt = np.float32(0.01)
    vel = b.vel + acc * (dt * 0.5)
    pos = b.pos + vel * dt
    rows, n = read_trajectory(out)
    np.testing.assert_allclose(rows.reshape(2, n, 5)[1, :, 1:4], pos.numpy(),
                               atol=1.1e-6, rtol=0)


@pytest.mark.parametrize("flags,missing", [
    (["--bh-ld", "9", "--bh-traversal", "fused"], "--bh-ld must be in [0, 8]"),
])
def test_cli_barnes_hut_unported_options(tmp_path, capsys, flags, missing):
    """A dense grid deeper than K6 takes exits 2 on the fused traversal."""
    assert main([TEN, "0", "1", "0.1", str(tmp_path / "o.csv"), *CPU64,
                 "--algo", "barnes-hut", *flags]) == 2
    assert missing in capsys.readouterr().err


def _outlier_cloud(tmp_path):
    rng = np.random.default_rng(2)
    arr = random_cloud(400, seed=2)
    arr[:5, :3] = rng.uniform(-1, 1, (5, 3)) * 1000.0
    src = tmp_path / "outliers.csv"
    write_fixture(src, arr)
    return src


def test_cli_robust_auto_resolves_on_and_refuses(tmp_path, capsys):
    """--bh-robust auto on an outlier-dominated cloud resolves to on
    (cli/main.py:642-666) and runs the exact hybrid; --bh-robust off runs
    the plain fused path; with --resort-every the hybrid runs on the
    persistent layout."""
    argv = [str(_outlier_cloud(tmp_path)), "0", "0.1", "0.1", str(tmp_path / "o.csv"),
            "--device", "cpu", "--algo", "barnes-hut", "--bh-traversal", "fused"]
    assert main(argv) == 0
    captured = capsys.readouterr()
    assert "enabling --bh-robust on" in captured.err
    assert "backend: torch/fused/robust" in captured.out
    assert main([*argv, "--bh-robust", "off"]) == 0
    assert "backend: torch/fused," in capsys.readouterr().out
    assert main([*argv, "--resort-every", "2"]) == 0
    captured = capsys.readouterr()
    assert "backend: torch/fused/robust/persistent" in captured.out
    assert "enabling --bh-robust on" in captured.err


@pytest.mark.parametrize("flags,fix", [
    (["--bh-frontier-cap", "128", "--bh-ld", "4", "--bh-leaf-cap", "1"],
     "--bh-frontier-cap"),
    (["--bh-keep-groups", "4"], "--bh-keep-groups"),
])
def test_cli_capacity_probe_exits_3(tmp_path, capsys, flags, fix):
    src = tmp_path / "in.csv"
    write_fixture(src, random_cloud(2000, seed=21))
    argv = [str(src), "0", "0.1", "0.1", str(tmp_path / "o.csv"), "--device", "cpu",
            "--algo", "barnes-hut", "--bh-traversal", "fused", "--bh-group-size", "64",
            *flags]
    assert main(argv) == 3
    err = capsys.readouterr().err
    assert "capacity overflow" in err and fix in err
    # without the probe the run goes ahead
    assert main([*argv, "--no-capacity-check"]) == 0


def _routed(want, dtype, algo):
    """The (function, group evaluator) the CLI builds for a backend."""
    force = build_force_fn(want, 1.0, 0.01, algo, dtype=dtype)
    return force.func, force.keywords.get("group_forces")


@pytest.mark.parametrize("backend,device,dtype,want", [
    ("auto", "cuda", "f32", "cuda"),
    ("torch", "cuda", "f64", "torch"),
    ("auto", "cpu", "f64", "torch"),
    ("auto", "cuda", "f64", "cuda"),
    ("cuda", "cuda", "f64", "cuda"),
])
def test_backend_routing_barnes_hut(backend, device, dtype, want):
    """Both dtypes run on the card: f64 through K6's df mode
    (barneshut_fused_df), with the df kernel or its plain version."""
    assert resolve_backend(backend, device) == want
    fn, group_forces = _routed(want, dtype, "barnes-hut")
    assert fn is (barneshut_fused_df if dtype == "f64" else barneshut_fused)
    kernels = {"f32": bh_fused.fused_group_forces, "f64": fused_group_forces_df}
    assert group_forces is (kernels[dtype] if want == "cuda"
                            else bh_fused.fused_group_forces_reference)


@pytest.mark.parametrize("n,want", [(10, "exhaustive"), (32_768, "exhaustive"),
                                    (32_769, "barnes-hut")])
def test_resolve_algo_auto(n, want):
    assert resolve_algo("auto", n) == want
    assert resolve_algo("exhaustive", n) == "exhaustive"


def test_cli_cuda_backend_on_cpu_refused(tmp_path, capsys):
    assert main([TEN, "0", "1", "0.1", str(tmp_path / "o.csv"),
                 "--device", "cpu", "--backend", "cuda"]) == 2
    assert "--backend cuda needs --device cuda" in capsys.readouterr().err


def test_cli_device_cuda_without_card_fails(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    out = tmp_path / "o.csv"
    assert main([TEN, "0", "1", "0.1", str(out)]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("backend,device,dtype,want", [
    ("auto", "cuda", "f32", "cuda"),
    ("auto", "cpu", "f32", "torch"),
    ("auto", "cpu", "f64", "torch"),
    ("torch", "cuda", "f64", "torch"),
    ("cuda", "cuda", "f32", "cuda"),
    ("auto", "cuda", "f64", "cuda"),
    ("cuda", "cuda", "f64", "cuda"),
    ("cuda", "cpu", "f32", "needs --device cuda"),
])
def test_backend_routing(backend, device, dtype, want):
    """The exhaustive force: K1 in f32, K4 in f64, or the plain path."""
    if want not in ("cuda", "torch"):
        with pytest.raises(ValueError, match=want):
            resolve_backend(backend, device)
        return
    assert resolve_backend(backend, device) == want
    fn, _ = _routed(want, dtype, "exhaustive")
    kernels = {"f32": cuda_accelerations, "f64": cuda_accelerations_f64}
    assert fn is (kernels[dtype] if want == "cuda" else exhaustive_accelerations)


def test_cli_sun_earth_f64_drift(capsys, tmp_path):
    """fp64 exhaustive on the solar system (SI units) for 8640 steps of
    1000 s: the relative energy drift is ~1e-12."""
    assert main([os.path.join(DATA_DIR, "sun_earth.csv"), "0", "8640000",
                 "1000", str(tmp_path / "o.csv"), *CPU64, "--G", "6.67e-11",
                 "--energy", "--no-output"]) == 0
    text = capsys.readouterr().out
    assert "time steps: 8640" in text
    drift = float(re.search(r"Relative energy drift: (\S+)", text).group(1))
    assert drift < 1e-10, drift


@pytest.mark.parametrize("traversal,backend,want", [
    ("auto", "cuda", "fused"),
    ("auto", "torch", "flat"),
    ("flat", "cuda", "flat"),
    ("padded", "torch", "padded"),
    ("fused", "torch", "fused"),
])
def test_resolve_traversal(traversal, backend, want):
    """auto is fused with the kernel backend and flat with the plain one,
    as JAX's auto is fused with pallas and flat with jnp."""
    assert resolve_traversal(traversal, backend) == want


@pytest.mark.parametrize("backend,dtype", [("cuda", "f32"), ("cuda", "f64"),
                                           ("torch", "f32"), ("torch", "f64")])
@pytest.mark.parametrize("traversal", ["flat", "padded"])
def test_backend_routing_list_path(backend, dtype, traversal):
    """A list traversal runs barneshut_accelerations with K7's wrapper for
    the dtype, or with K7's plain version under --backend torch."""
    force = build_force_fn(backend, 1.0, 0.01, "barnes-hut", dtype=dtype,
                           bh_kw={"list_size": 512}, traversal=traversal)
    assert force.func is barneshut.barneshut_accelerations
    assert force.keywords["traversal"] == traversal
    assert force.keywords["list_size"] == 512
    kernels = {"f32": cuda_lists.eval_lists, "f64": cuda_lists.eval_lists_f64}
    assert force.keywords["group_forces"] is (
        kernels[dtype] if backend == "cuda" else cuda_lists.eval_lists_reference)


@pytest.mark.parametrize("traversal", ["flat", "padded", "auto"])
def test_cli_list_traversals_at_10_bodies(tmp_path, capsys, traversal):
    """At 10 bodies the one group's box holds every centre of mass and the
    root holds fewer than leaf_cap bodies, so the list path is exact: 10
    steps match the all-pairs golden trajectory within its %lf
    resolution.  auto with --backend torch is the flat traversal."""
    out = tmp_path / "o.csv"
    assert main([TEN, "0", "1", "0.1", str(out), *CPU64, "--algo", "barnes-hut",
                 "--bh-traversal", traversal, "--bh-list-size", "64", "--energy"]) == 0
    text = capsys.readouterr().out
    assert "Algorithm: barnes-hut, backend: torch, dtype: f64" in text
    assert "Relative energy drift:" in text
    golden = np.loadtxt(GOLDEN, delimiter=",")[:110]
    np.testing.assert_allclose(np.loadtxt(out, delimiter=","), golden, atol=1.1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cli_list_path_matches_plain_call(tmp_path, capsys, dtype):
    """The CLI's flat Barnes-Hut force is barneshut_accelerations with the
    flags' knobs: one KDK step of a 2,000-body cloud against the same step
    by hand."""
    arr = random_cloud(2000, seed=4)
    src, out = tmp_path / "in.csv", tmp_path / "o.csv"
    write_fixture(src, arr)
    assert main([str(src), "0", "0.01", "0.01", str(out), "--device", "cpu",
                 "--dtype", dtype, "--algo", "barnes-hut", "--bh-traversal", "flat",
                 "--bh-group-size", "64", "--bh-leaf-cap", "8", "--bh-list-size", "1024",
                 "--theta", "0.6"]) == 0
    assert f"backend: torch, dtype: {dtype}" in capsys.readouterr().out
    tdt = torch.float64 if dtype == "f64" else torch.float32
    b = Bodies.from_numpy(read_bodies(str(src)), dtype=tdt)
    acc = barneshut.barneshut_accelerations(b.pos, b.mass, theta=0.6, group_size=64,
                                            leaf_cap=8, list_size=1024)
    dt = np.float32(0.01) if dtype == "f32" else float(np.float32(0.01))
    pos = b.pos + (b.vel + acc * (dt * 0.5)) * dt
    rows, n = read_trajectory(out)
    np.testing.assert_allclose(rows.reshape(2, n, 5)[1, :, 1:4], pos.numpy(),
                               atol=1.1e-6, rtol=0)


def test_cli_list_size_overflow_exits_3(tmp_path, capsys):
    """The probe runs the run's own traversal: lists of 8 cannot hold the 10
    bodies, so it exits 3 naming --bh-list-size 10, which then runs."""
    argv = [TEN, "0", "0.1", "0.1", str(tmp_path / "o.csv"), *CPU64, "--algo",
            "barnes-hut", "--bh-traversal", "padded"]
    assert main([*argv, "--bh-list-size", "8"]) == 3
    err = capsys.readouterr().err
    assert "capacity overflow" in err and "--bh-list-size 10" in err
    assert main([*argv, "--bh-list-size", "10"]) == 0


@pytest.mark.parametrize("flags,said", [
    ([], "enabling --bh-robust on"),
    (["--bh-robust", "on"], "--bh-robust applies to the fused traversal only"),
    (["--resort-every", "4"], "--resort-every requires the fused Barnes-Hut path"),
])
def test_cli_list_path_warns_and_runs(tmp_path, capsys, flags, said):
    """On a list traversal --bh-robust and --resort-every do nothing, in JAX
    too: the run prints the note or warning and goes on (the outliers also
    merge a terminal cell, which warns and goes on as in JAX)."""
    out = tmp_path / "o.csv"
    assert main([str(_outlier_cloud(tmp_path)), "0", "0.1", "0.1", str(out), "--device",
                 "cpu", "--algo", "barnes-hut", "--bh-list-size", "1024", *flags]) == 0
    captured = capsys.readouterr()
    assert said in captured.err
    assert "backend: torch, dtype: f32" in captured.out
    rows, _ = read_trajectory(out)
    assert np.isfinite(rows).all()


def _eps_file(tmp_path, values):
    path = tmp_path / "eps.txt"
    path.write_text("\n".join(repr(float(v)) for v in values) + "\n")
    return str(path)


def test_cli_softening_per_body_flag(tmp_path, capsys):
    """test_softening.py::test_cli_flag's twin: the flag runs; a wrong count
    and a tree algorithm exit with JAX's messages."""
    out = tmp_path / "out.csv"
    argv = [TEN, "0", "1", "0.1", str(out), "--device", "cpu", "--algo", "exhaustive"]
    assert main([*argv, "--softening-per-body", _eps_file(tmp_path, [0.05] * 10)]) == 0
    assert out.exists()
    capsys.readouterr()
    assert main([*argv, "--softening-per-body", _eps_file(tmp_path, [0.05] * 2)]) != 0
    assert "2 values for 10 bodies" in capsys.readouterr().err
    argv[argv.index("exhaustive")] = "barnes-hut"
    assert main([*argv, "--softening-per-body", _eps_file(tmp_path, [0.05] * 10)]) != 0
    assert "requires --algo exhaustive" in capsys.readouterr().err


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cli_softening_per_body_matches_oracle(tmp_path, dtype):
    """One KDK step with per-body softening against the same step from the
    fp64 per-body oracle (test_softening.py:34-39), within the frames'
    %lf resolution (f64) or the f32 kernel bound."""
    arr = read_bodies(os.path.join(DATA_DIR, "100_bodies_g1.csv"))
    eps = np.random.default_rng(4).uniform(0.01, 0.1, 100)
    out = tmp_path / "o.csv"
    assert main([os.path.join(DATA_DIR, "100_bodies_g1.csv"), "0", "0.01", "0.01", str(out),
                 "--device", "cpu", "--dtype", dtype, "--G", "1",
                 "--softening-per-body", _eps_file(tmp_path, eps)]) == 0
    pos, vel, mass = arr[:, :3], arr[:, 3:6], arr[:, 6]
    e2 = eps * eps
    d = pos[None] - pos[:, None]
    r2 = (d * d).sum(-1) + 0.5 * (e2[:, None] + e2[None, :])
    acc = np.einsum("ij,ijk->ik", r2 ** -1.5 * mass[None], d)
    dt = float(np.float32(0.01))
    want = pos + (vel + acc * (dt * 0.5)) * dt
    rows = np.loadtxt(out, delimiter=",").reshape(2, 100, 5)
    np.testing.assert_allclose(rows[1, :, 1:4], want, atol=1.1e-6 if dtype == "f64" else 2e-6,
                               rtol=0)


def test_softening_per_body_refusals(tmp_path):
    """f64 on the kernel backend refuses, as JAX's pallas-df does
    (cli/main.py:396-400); the plain backend reads the file."""
    path = _eps_file(tmp_path, [0.05] * 10)
    with pytest.raises(ValueError, match="no fp64 kernel"):
        read_softening_per_body(path, 10, "exhaustive", "f64", "cuda")
    np.testing.assert_array_equal(read_softening_per_body(path, 10, "exhaustive", "f64",
                                                          "torch"), np.full(10, 0.05))
    np.testing.assert_array_equal(read_softening_per_body(path, 10, "exhaustive", "f32",
                                                          "cuda"), np.full(10, 0.05))
    with pytest.raises(ValueError, match="requires --algo exhaustive"):
        read_softening_per_body(path, 10, "barnes-hut", "f32", "torch")


@pytest.mark.parametrize("backend,dtype", [("cuda", "f32"), ("torch", "f32"),
                                           ("torch", "f64")])
def test_per_body_routing(backend, dtype):
    """ε² per body reaches K1's wrapper or the plain function."""
    e2 = torch.full((10,), 0.01)
    force = build_force_fn(backend, 1.0, 0.01, dtype=dtype, eps2_per_body=e2)
    assert force.func is (cuda_accelerations if backend == "cuda"
                          else exhaustive_accelerations)
    assert force.keywords["eps2_per_body"] is e2
    with pytest.raises(ValueError, match="per-body"):
        build_force_fn("cuda", 1.0, 0.01, dtype="f64", eps2_per_body=e2)


@pytest.mark.parametrize("backend,dtype", [("cuda", "f32"), ("cuda", "f64"),
                                           ("torch", "f32"), ("torch", "f64")])
def test_backend_routing_robust(backend, dtype):
    """The robust hybrid: K6 (or its df mode) and K1 (or K4) with the cuda
    backend, both plain versions with torch."""
    from nbody_tpu_torch.ops.bh_fused import barneshut_fused_robust
    from nbody_tpu_torch.ops.bh_fused_df import barneshut_fused_robust_df
    from nbody_tpu_torch.ops.cuda_exhaustive import (
        cuda_rect_accelerations,
        rect_accelerations_reference,
    )
    from nbody_tpu_torch.ops.cuda_fp64 import cuda_rect_accelerations_f64

    force = build_force_fn(backend, 1.0, 0.01, "barnes-hut", dtype=dtype, robust=True)
    assert force.func is (barneshut_fused_robust_df if dtype == "f64"
                          else barneshut_fused_robust)
    kernels = {"f32": (bh_fused.fused_group_forces, cuda_rect_accelerations),
               "f64": (fused_group_forces_df, cuda_rect_accelerations_f64)}
    plain = (bh_fused.fused_group_forces_reference, rect_accelerations_reference)
    want = kernels[dtype] if backend == "cuda" else plain
    assert (force.keywords["group_forces"], force.keywords["rect_forces"]) == want


def test_cli_backend_torch_takes_the_mxu_mode_above_2048(tmp_path):
    """--backend torch is exhaustive_accelerations in JAX's auto mode: mxu
    above 2,048 bodies, as JAX's --backend jnp (exhaustive.py:191-192)."""
    arr = random_cloud(2100, seed=8)
    src, out = tmp_path / "in.csv", tmp_path / "o.csv"
    write_fixture(src, arr)
    assert main([str(src), "0", "0.01", "0.01", str(out), "--device", "cpu"]) == 0
    b = Bodies.from_numpy(read_bodies(str(src)), dtype=torch.float32)
    acc = exhaustive_accelerations(b.pos, b.mass, mode="mxu")
    dt = np.float32(0.01)
    want = b.pos + (b.vel + acc * (dt * 0.5)) * dt
    rows, n = read_trajectory(out)
    np.testing.assert_allclose(rows.reshape(2, n, 5)[1, :, 1:4], want.numpy(), atol=1.1e-6,
                               rtol=0)


def _cloud_csv(tmp_path, n=400, seed=3):
    src = tmp_path / "cloud.csv"
    write_fixture(src, random_cloud(n, seed=seed))
    return str(src)


PERSISTENT = ["--device", "cpu", "--algo", "barnes-hut", "--bh-traversal", "fused",
              "--bh-group-size", "128"]


@pytest.mark.parametrize("robust", ["off", "on"])
def test_cli_resort_every_matches_per_step_resort(tmp_path, capsys, robust):
    """--resort-every 4 (the persistent layout, 4 unsorted steps) gives the
    frames of --resort-every 1 within the persistent tests' 1e-5
    (tests/test_bh_persistent.py:68-84), plain and robust; the banner names
    the layout."""
    src = _cloud_csv(tmp_path)
    frames = {}
    for k in (4, 1):
        out = tmp_path / f"k{k}.csv"
        assert main([src, "0", "0.004", "0.001", str(out), *PERSISTENT, "--resort-every",
                     str(k), "--bh-robust", robust]) == 0
        assert "/persistent, dtype: f32" in capsys.readouterr().out
        rows, n = read_trajectory(out)
        frames[k] = rows.reshape(-1, n, 5)
    assert frames[4].shape[0] == 5
    np.testing.assert_allclose(frames[4], frames[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("traversal,phases", [
    ("fused", ("sort", "grid", "group", "kernel", "scatter")),
    ("flat", ("sort+build+group", "traverse", "eval", "scatter")),
])
def test_cli_timers(tmp_path, capsys, traversal, phases):
    """--timers prints the per-phase breakdown of one evaluation before the
    run (cli/main.py:777-797), on either traversal."""
    assert main([_cloud_csv(tmp_path), "0", "0.001", "0.001", str(tmp_path / "o.csv"),
                 "--device", "cpu", "--algo", "barnes-hut", "--bh-traversal", traversal,
                 "--bh-list-size", "1024", "--timers", "--no-output"]) == 0
    text = capsys.readouterr().out
    report = text[text.index("Per-phase force-eval breakdown:"):text.index("Start:")]
    for name in (*phases, "TOTAL (one call)", "phases / total"):
        assert re.search(rf"^  {re.escape(name)} +[0-9.]+( ms)?$", report, re.M), name


def test_cli_trace_devices_progress_block(tmp_path, capsys):
    """--trace writes a Chrome trace, --devices prints the device and the
    run goes on, --progress prints a heartbeat every K steps, --block-i and
    --block-j are noted and ignored (K1 picks its own tile)."""
    out = tmp_path / "o.csv"
    assert main([TEN, "0", "0.4", "0.1", str(out), *CPU64, "--trace",
                 str(tmp_path / "tr"), "--devices", "--progress", "2", "--block-i", "64",
                 "--block-j", "128"]) == 0
    captured = capsys.readouterr()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert captured.out.startswith("device cpu:")
    beats = re.findall(r"^progress: step (\d+)/4 ", captured.err, re.M)
    assert beats == ["2", "4"]
    assert "--block-i/--block-j are the Pallas all-pairs tile sizes" in captured.err
    assert read_trajectory(out)[0].shape[0] == 5 * 10


@pytest.mark.parametrize("flags", [[], PERSISTENT + ["--resort-every", "2"]])
def test_cli_debug_nans_stops(tmp_path, capsys, flags):
    """--debug-nans stops a run whose input holds a NaN with exit 1 and a
    message, exhaustive and persistent; without it the run goes on."""
    arr = random_cloud(300, seed=5)
    arr[7, 1] = np.nan
    src = tmp_path / "nan.csv"
    write_fixture(src, arr)
    argv = [str(src), "0", "0.002", "0.001", str(tmp_path / "o.csv"), "--device", "cpu",
            "--no-capacity-check", *flags]
    assert main([*argv, "--debug-nans"]) == 1
    err = capsys.readouterr().err
    assert "--debug-nans: non-finite" in err and "stopping the run" in err
    assert main(argv) == 0


# ---- checkpoints, adaptive dt, merging and block tiers ----------------------


def test_cli_lacks_only_the_multi_chip_flags():
    """Against the JAX parser, the port's lacks exactly the five multi-chip
    flags (--shard, --mesh-shape, --jstream, --bucket-frac, --halo-cap)."""
    from nbody_tpu.cli.main import build_parser as jax_parser
    from nbody_tpu_torch.cli.main import build_parser

    def flags(p):
        return {s for a in p._actions for s in a.option_strings}
    assert flags(jax_parser()) - flags(build_parser()) == {
        "--shard", "--mesh-shape", "--jstream", "--bucket-frac", "--halo-cap"}


def _outcome(fn, argv, capsys):
    """(exit status, message) of one in-process CLI call: a return code
    with stderr's error line, SystemExit's code (a message is status 1),
    or an exception raised out of the CLI (status 1 as a process)."""
    try:
        rc = fn(argv)
        said = capsys.readouterr().err
        return rc, said.strip().splitlines()[-1] if said.strip() else ""
    except SystemExit as e:
        capsys.readouterr()
        return (1, str(e.code)) if isinstance(e.code, str) else (e.code, "")
    except ValueError as e:
        capsys.readouterr()
        return 1, f"error: {e}"


FUSED = ["--algo", "barnes-hut", "--bh-traversal", "fused", "--no-capacity-check"]


@pytest.mark.parametrize("flags", [
    ["--block-tiers", "2"],
    [*FUSED, "--resort-every", "2", "--merge-radius", "0.1", "--block-tiers", "2"],
    [*FUSED, "--resort-every", "2", "--merge-radius", "0.1", "--adaptive-eta", "0.01"],
    [*FUSED, "--resort-every", "2", "--adaptive-eta", "0.01", "--block-tiers", "2"],
    [*FUSED, "--resort-every", "2", "--block-tiers", "2", "--softening2", "0"],
    [*FUSED, "--resort-every", "2", "--adaptive-eta", "0.01", "--softening2", "0"],
    ["--adaptive-eta", "0.01", "--integrator", "yoshida4"],
    ["--adaptive-eta", "0.01", "--merge-radius", "0.1"],
    ["--adaptive-eta", "0.01", "--softening2", "0"],
    ["--merge-radius", "0.1", "--integrator", "yoshida4"],
    ["--resume"],
], ids=["tiers-one-shot", "merge-tiers", "merge-adaptive", "adaptive-tiers",
        "tiers-no-softening", "persistent-adaptive-no-softening", "adaptive-yoshida",
        "adaptive-merge", "adaptive-no-softening", "merge-yoshida", "resume-no-file"])
def test_cli_refusals_match_jax(tmp_path, capsys, flags):
    """Each refusal of the ten flags' combinations (cli/main.py:958-977,
    1061-1065, 1146-1170, the persistent path's ValueError exit 2, a
    missing checkpoint) exits with JAX's status and message; where JAX
    lets the adaptive criterion's ValueError out of main (status 1 as a
    process), the port prints it and returns 1."""
    src = str(tmp_path / "nope.csv") if flags == ["--resume"] else TEN
    argv = [src, "0", "0.2", "0.1", str(tmp_path / "o.csv"), *flags]
    want = _outcome(jax_main, argv, capsys)
    got = _outcome(main, [*argv, "--device", "cpu"], capsys)
    assert want[0] != 0 and got == want


def test_cli_merge_on_the_persistent_layout(tmp_path, capsys):
    """tests/test_collisions.py:155-186: --merge-radius with --resort-every
    merges, reports, and writes the running masses in the frames' mass
    column: the initial frame all live, the last with the absorbed ghosts;
    the one-shot run reports the same count."""
    counts = {}
    for name, extra in (("persistent", PERSISTENT + ["--resort-every", "2"]),
                        ("one-shot", ["--device", "cpu"])):
        out = tmp_path / f"{name}.csv"
        assert main([TEN, "0", "0.002", "0.001", str(out), "--merge-radius", "5.0",
                     *extra]) == 0
        k = counts[name] = int(capsys.readouterr().out.split("Merged bodies:")[1].split()[0])
        rows, n = read_trajectory(out)
        assert k > 0 and (rows[-n:, 4] == 0).sum() == k and (rows[:n, 4] > 0).all()
    assert counts["persistent"] == counts["one-shot"]


def test_cli_block_tiers_prefix_equals_masked(tmp_path, capsys):
    """tests/test_bh_block.py:281-303 on the port's CLI: --block-tiers 2
    on the persistent layout runs, and --block-prefix writes the same
    bytes."""
    src = os.path.join(DATA_DIR, "100_bodies_g1.csv")
    outs = []
    for extra in ([], ["--block-prefix"]):
        outs.append(tmp_path / f"o{len(outs)}.csv")
        assert main([src, "0", "0.3", "0.1", str(outs[-1]), *PERSISTENT, "--bh-group-size",
                     "64", "--resort-every", "3", "--block-tiers", "2", "--softening2", "0.01",
                     "--G", "1"]) == 0
    assert open(outs[0]).read() == open(outs[1]).read()
    assert "/persistent, dtype: f32" in capsys.readouterr().out


def test_cli_adaptive_on_the_persistent_layout(tmp_path, capsys):
    """--adaptive-eta with --resort-every takes the persistent adaptive run
    and prints its steps; frames hold the initial one and one a real
    step."""
    out = tmp_path / "o.csv"
    assert main([_cloud_csv(tmp_path), "0", "0.003", "0.001", str(out), *PERSISTENT,
                 "--resort-every", "2", "--adaptive-eta", "0.05"]) == 0
    text = capsys.readouterr().out
    taken = int(text.split("Adaptive steps taken:")[1].split()[0])
    rows, n = read_trajectory(out)
    assert taken >= 3 and rows.shape[0] == (taken + 1) * n


def test_cli_adaptive_checkpoint_holds_the_run_time(tmp_path, capsys):
    """A checkpoint of the persistent adaptive run holds the time the run
    reached (f32 t_end at the last step), not t0 + steps · dt_max as JAX's
    CLI writes, a later time when the steps were shorter than dt_max."""
    import json

    out, ck = tmp_path / "o.csv", tmp_path / "c.csv"
    assert main([_cloud_csv(tmp_path), "0", "0.003", "0.003", str(out), *PERSISTENT,
                 "--resort-every", "1", "--adaptive-eta", "0.001", "--no-output",
                 "--checkpoint-every", "1", "--checkpoint", str(ck)]) == 0
    taken = int(capsys.readouterr().out.split("Adaptive steps taken:")[1].split()[0])
    meta = json.loads((tmp_path / "c.csv.meta.json").read_text())
    assert taken > 1 and meta["step"] == taken
    assert meta["time"] == float(np.float32(0.003)) < taken * 0.003
