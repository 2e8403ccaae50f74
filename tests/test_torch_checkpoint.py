"""The port's checkpoint I/O (nbody_tpu_torch/io/checkpoint.py) and its
native writer (nbody_tpu_torch/native/): files byte-compatible with the JAX
package's, either package loading the other's, and the CLI's resume
byte-matching the uninterrupted run (tests/test_checkpoint.py)."""

import filecmp
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DATA_DIR, random_cloud
from nbody_tpu.cli.main import main as jax_main
from nbody_tpu.core.types import Bodies as JBodies
from nbody_tpu.io import checkpoint as jck
from nbody_tpu.native import loader as jax_loader
from nbody_tpu_torch.cli.main import main
from nbody_tpu_torch.core.types import Bodies
from nbody_tpu_torch.io import checkpoint as tck
from nbody_tpu_torch.io.csv import read_trajectory
from nbody_tpu_torch.native import loader


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SRC = os.path.join(DATA_DIR, "10_bodies.csv")
F64 = ["--device", "cpu", "--dtype", "f64", "--backend", "torch"]


def _adversarial(n=64, seed=52):
    """tests/test_checkpoint.py:28-35's values for shortest round-trip
    formatting."""
    arr = random_cloud(n, seed=seed)
    arr[0, 0] = 0.1 + 0.2
    arr[1, 1] = 1e-300
    arr[2, 2] = -1.7976931348623157e308
    arr[3, 3] = 5e-324
    arr[4, 4] = 0.0
    arr[5, 5] = -0.0
    arr[6, 6] = 1e-4
    return arr


def test_native_builds_from_its_own_copy():
    """The loader compiles nbody_tpu_torch/native/fastcsv.cpp, a copy of the
    JAX package's source, and binds write7."""
    here = os.path.join(os.path.dirname(loader.__file__), "fastcsv.cpp")
    assert os.path.samefile(loader._SRC, here)
    assert os.path.dirname(os.path.abspath(loader._SRC)).endswith(
        os.path.join("nbody_tpu_torch", "native"))
    with open(here, "rb") as a, open(jax_loader._SRC, "rb") as b:
        assert a.read() == b.read()
    lib = loader.get()
    assert lib is not None and hasattr(lib, "write7")


def test_write7_exact_and_byte_equal_to_jax(tmp_path):
    """write7's CSV reads back exactly under float() of each value, and is
    byte-equal to the JAX package's writer on the same array."""
    arr = _adversarial()
    ours, theirs = str(tmp_path / "t.csv"), str(tmp_path / "j.csv")
    assert loader.get().write7(ours, arr)
    assert jax_loader.get().write7(theirs, arr)
    assert filecmp.cmp(ours, theirs, shallow=False)
    with open(ours) as f:
        back = np.array([[float(v) for v in line.split(",")] for line in f])
    assert np.array_equal(back.view(np.int64), arr.view(np.int64))  # -0.0 kept


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_checkpoints_cross_load(tmp_path, dtype):
    """The port's checkpoint of a state is byte-equal to JAX's (file and
    sidecar); JAX's loader reads the port's and the port's JAX's, arrays
    and sidecars equal; the Python fallback writes the same values."""
    arr = random_cloud(50, seed=51)
    tb = Bodies.from_numpy(arr, dtype=torch.float32 if dtype == "f32" else torch.float64)
    jb = JBodies.from_numpy(arr, dtype=jnp.float32 if dtype == "f32" else jnp.float64)
    p_t, p_j = tmp_path / "t.ckpt.csv", tmp_path / "j.ckpt.csv"
    tck.save_checkpoint(p_t, tb, step=42, time=4.2)
    jck.save_checkpoint(p_j, jb, step=42, time=4.2)
    assert filecmp.cmp(p_t, p_j, shallow=False)
    assert filecmp.cmp(f"{p_t}.meta.json", f"{p_j}.meta.json", shallow=False)
    a_j, m_j = jck.load_checkpoint(p_t)
    a_t, m_t = tck.load_checkpoint(p_j)
    assert np.array_equal(a_j, a_t) and np.array_equal(a_t, tb.to_numpy().astype(np.float64))
    assert m_j == m_t == {"n_bodies": 50, "step": 42, "time": 4.2}


def test_python_fallback_is_exact(tmp_path, monkeypatch):
    """Without the native library the writer formats with repr(): the same
    values, read back exactly."""
    arr = _adversarial(16)
    monkeypatch.setattr(loader, "get", lambda: None)
    p = tmp_path / "py.ckpt.csv"
    tck.save_checkpoint(p, Bodies.from_numpy(arr, dtype=torch.float64))
    back, meta = tck.load_checkpoint(p)
    assert np.array_equal(back.view(np.int64), arr.view(np.int64))
    assert meta == {"n_bodies": 16}


def test_checkpoint_rotation(tmp_path):
    """keep=3: the newest at path, older at path.1 and path.2 with their
    sidecars, the oldest dropped (tests/test_checkpoint.py:124-140)."""
    b = Bodies.from_numpy(random_cloud(20, seed=7), dtype=torch.float64)
    p = tmp_path / "ck.csv"
    with tck.CheckpointManager(p, keep=3) as mgr:
        for step in (10, 20, 30, 40):
            mgr.save(b, step=step, time=step * 0.1)
    for path, step in ((p, 40), (f"{p}.1", 30), (f"{p}.2", 20)):
        assert tck.load_checkpoint(path)[1]["step"] == step
    assert not os.path.exists(f"{p}.3") and not os.path.exists(f"{p}.3.meta.json")


def _interrupted(tmp_path, name, extra=()):
    """The 10-body run to t = 5 with a checkpoint at its last step, then
    --resume to t = 10, in f64; returns (output, full run's output)."""
    out, ck = tmp_path / f"{name}.csv", tmp_path / f"{name}.ck.csv"
    full = tmp_path / f"{name}_full.csv"
    assert main([SRC, "0", "10", "0.1", str(full), *F64, *extra]) == 0
    assert main([SRC, "0", "5", "0.1", str(out), *F64, *extra, "--checkpoint-every", "50",
                 "--checkpoint", str(ck)]) == 0
    assert json.load(open(f"{ck}.meta.json"))["step"] == 50
    assert main([str(ck), "0", "10", "0.1", str(out), "--resume", *F64, *extra]) == 0
    return out, full


@pytest.mark.parametrize("extra", [[], ["--write-every", "4"]])
def test_cli_resume_byte_matches_uninterrupted(tmp_path, extra):
    """tests/test_checkpoint.py:81-121: the resumed run's trajectory is
    byte-identical to the uninterrupted one, and the --write-every stride
    holds across the interruption (global frame numbering)."""
    out, full = _interrupted(tmp_path, "run", extra)
    assert open(out).read() == open(full).read()


def test_cli_resume_of_a_jax_checkpoint(tmp_path, capsys):
    """The port resumes a checkpoint the JAX CLI wrote, and JAX one the port
    wrote: each final frame within the checkpoint test's 2e-6 of the
    other package's uninterrupted run (tests/test_checkpoint.py:44-78)."""
    ck_j, ck_t = tmp_path / "j.ck.csv", tmp_path / "t.ck.csv"
    assert jax_main([SRC, "0", "5", "0.1", str(tmp_path / "a.csv"), "--dtype", "f64",
                     "--no-output", "--checkpoint-every", "25", "--checkpoint",
                     str(ck_j)]) == 0
    assert main([SRC, "0", "5", "0.1", str(tmp_path / "b.csv"), *F64, "--no-output",
                 "--checkpoint-every", "25", "--checkpoint", str(ck_t)]) == 0
    assert filecmp.cmp(f"{ck_j}.meta.json", f"{ck_t}.meta.json", shallow=False)
    res_t, res_j = tmp_path / "res_t.csv", tmp_path / "res_j.csv"
    assert main([str(ck_j), "0", "10", "0.1", str(res_t), "--resume", *F64]) == 0
    assert jax_main([str(ck_t), "0", "10", "0.1", str(res_j), "--resume",
                     "--dtype", "f64"]) == 0
    assert "Resuming from" in capsys.readouterr().out
    rows_t, _ = read_trajectory(res_t)
    rows_j, _ = read_trajectory(res_j)
    assert rows_t.shape == rows_j.shape == (51 * 10, 5)
    np.testing.assert_allclose(rows_t[-10:, 1:4], rows_j[-10:, 1:4], atol=2e-6, rtol=0)


def test_cli_persistent_checkpoint_roundtrip(tmp_path):
    """tests/test_checkpoint.py:143-177: --resort-every with
    --checkpoint-every emits the group layout through its permutation into
    a loadable (pos, vel, mass) snapshot, and --resume runs from it: a fresh
    layout, so the resumed run's last frame agrees with the uninterrupted
    one to the Barnes-Hut tolerance of the persistent tests (1e-5)."""
    src = os.path.join(DATA_DIR, "100_bodies_g1.csv")
    flags = ["--device", "cpu", "--algo", "barnes-hut", "--bh-traversal", "fused",
             "--bh-group-size", "64", "--resort-every", "2", "--G", "1"]
    ck, out, full = tmp_path / "c.csv", tmp_path / "o.csv", tmp_path / "f.csv"
    assert main([src, "0", "0.4", "0.1", str(out), *flags, "--checkpoint-every", "2",
                 "--checkpoint", str(ck)]) == 0
    arr, meta = tck.load_checkpoint(ck)
    assert arr.shape == (100, 7) and meta["step"] == 4 and np.isfinite(arr).all()
    assert main([src, "0", "0.6", "0.1", str(full), *flags]) == 0
    assert main([str(ck), "0", "0.6", "0.1", str(out), "--resume", *flags]) == 0
    rows_o, n = read_trajectory(out)
    rows_f, _ = read_trajectory(full)
    assert rows_o.shape == rows_f.shape
    np.testing.assert_allclose(rows_o[-n:], rows_f[-n:], atol=1e-5, rtol=0)
