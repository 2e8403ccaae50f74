"""The port's adaptive time stepping (nbody_tpu_torch/integrate/adaptive.py)
held against the JAX package's jnp ``adaptive_steps`` and
``simulate_adaptive`` in f32 and f64, and twins of tests/test_adaptive.py."""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import DATA_DIR
from nbody_tpu.cli.main import main as jax_main
from nbody_tpu.core.types import Bodies as JBodies
from nbody_tpu.integrate import adaptive as ja
from nbody_tpu.ops.exhaustive import exhaustive_accelerations as jax_exhaustive
from nbody_tpu_torch.cli.main import main
from nbody_tpu_torch.core.types import Bodies
from nbody_tpu_torch.integrate import adaptive as ta
from nbody_tpu_torch.io.csv import read_trajectory
from nbody_tpu_torch.ops.exhaustive import exhaustive_accelerations


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EPS2 = 1e-6
DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "f64": (np.float64, torch.float64, jnp.float64)}
# final-state tolerance against JAX over the whole run: the two packages'
# forces differ in summation order, and an eccentric orbit amplifies it
STATE_ATOL = {"f32": 1e-4, "f64": 1e-11}


def _kepler(e, dtype):
    """tests/test_adaptive.py:25-36: two bodies on an eccentricity-e orbit
    at apocenter, G = 1, a = 1; both packages' Bodies."""
    nd, td, jd = DTYPES[dtype]
    m1, m2 = 1.0, 1e-3
    r_apo = 1.0 + e
    v_apo = math.sqrt((1 + m2) * (2.0 / r_apo - 1.0))
    arr = [np.array([[0.0, 0, 0], [r_apo, 0, 0]]),
           np.array([[0.0, -m2 * v_apo / (1 + m2), 0], [0.0, v_apo / (1 + m2), 0]]),
           np.array([m1, m2])]
    return (Bodies(*(torch.as_tensor(a.astype(nd)) for a in arr)),
            JBodies(*(jnp.asarray(a, jd) for a in arr)))


def _tforce(p, m):
    return exhaustive_accelerations(p, m, G=1.0, softening_sq=EPS2)


def _jforce(p, m):
    return jax_exhaustive(p, m, G=1.0, softening_sq=EPS2)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_simulate_adaptive_matches_jax(dtype):
    """The eccentric orbit of tests/test_adaptive.py:51-70 on both packages:
    equal step counts, the same final state within STATE_ATOL."""
    tb, jb = _kepler(0.9, dtype)
    kw = dict(eta=0.25, softening_sq=EPS2, dt_max=0.05, chunk_steps=64)
    t_out, t_taken = ta.simulate_adaptive(tb, 0.0, 6.5, _tforce, **kw)
    j_out, j_taken = ja.simulate_adaptive(jb, 0.0, 6.5, _jforce, **kw)
    assert t_taken == j_taken > 200
    np.testing.assert_allclose(t_out.pos.numpy(), np.asarray(j_out.pos),
                               atol=STATE_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_adaptive_steps_match_jax_and_land(dtype):
    """tests/test_adaptive.py:73-103 on both packages: chunks of 32 steps
    from t = 0 to 0.731.  JAX's last chunk goes on past arrival with dt = 0
    identity steps, the port's stops there: its steps are JAX's real ones,
    ts and dts within 1e-6 (f32) or 1e-12 (f64) of JAX's, the last ts
    exactly the dtype's t_end, dts within dt_max, time strictly advancing,
    and one chunk long enough for the run takes the same steps."""
    nd = DTYPES[dtype][0]
    tb, jb = _kepler(0.1, dtype)
    t_end, kw = 0.731, dict(eta=0.01, eps=math.sqrt(EPS2), dt_min=0.0, dt_max=0.05)
    got, want = [], []
    t_t, t_j, acc_t, acc_j = 0.0, jnp.asarray(0.0, DTYPES[dtype][2]), None, None
    b_t, b_j = tb, jb
    for _ in range(40):
        b_t, acc_t, t_t, (ts, dts) = ta.adaptive_steps(b_t, 32, t_t, t_end, _tforce,
                                                       acc0=acc_t, **kw)
        b_j, acc_j, t_j, (jts, jdts) = ja.adaptive_steps(b_j, 32, t_j, t_end, _jforce,
                                                         acc0=acc_j, **kw)
        got.append((ts.numpy(), dts.numpy()))
        want.append((np.asarray(jts), np.asarray(jdts)))
        if float(t_j) >= float(nd(t_end)):
            break
    ts, dts = (np.concatenate([g[i] for g in got]) for i in (0, 1))
    jts, jdts = (np.concatenate([w[i] for w in want]) for i in (0, 1))
    real = jdts > 0
    assert np.all(dts > 0) and dts.shape[0] == real.sum() > 50 and not real[-1]
    tol = 1e-6 if dtype == "f32" else 1e-12
    np.testing.assert_allclose(ts, jts[real], atol=tol, rtol=0)
    np.testing.assert_allclose(dts, jdts[real], atol=tol, rtol=0)
    assert ts[-1] == nd(t_end) and float(t_t) == nd(t_end) and np.all(dts <= nd(0.05))
    assert np.all(np.diff(ts) > 0) and np.all(jts[~real] == nd(t_end))
    b, _, t, (ts1, _) = ta.adaptive_steps(tb, 4096, 0.0, t_end, _tforce, **kw)
    assert ts1.shape[0] == dts.shape[0] and float(t) == nd(t_end)
    np.testing.assert_array_equal(b.pos.numpy(), b_t.pos.numpy())


def test_frames_one_row_per_real_step():
    """tests/test_adaptive.py:106-117: the initial frame plus one row per
    real step, chunked as the chunk length says."""
    tb, _ = _kepler(0.1, "f64")
    frames = []
    out, taken = ta.simulate_adaptive(tb, 0.0, 0.3, _tforce, eta=0.01, softening_sq=EPS2,
                                      dt_max=0.05, chunk_steps=16,
                                      frame_writer=frames.append)
    assert sum(f.shape[0] for f in frames) == taken + 1
    assert np.array_equal(frames[0][0], tb.pos.numpy())
    assert np.array_equal(frames[-1][-1], out.pos.numpy())


def test_refusals_and_stagnation():
    """softening_sq <= 0 and dt_max <= 0 are refused (tests/test_adaptive.py:
    120-124); a dt_max below the f32 time resolution at t stagnates and
    raises instead of spinning; max_steps stops between chunks."""
    tb, _ = _kepler(0.9, "f32")
    with pytest.raises(ValueError, match="softening_sq > 0"):
        ta.simulate_adaptive(tb, 0.0, 1.0, _tforce, softening_sq=0.0, dt_max=0.05)
    with pytest.raises(ValueError, match="dt_max must be > 0"):
        ta.simulate_adaptive(tb, 0.0, 1.0, _tforce, softening_sq=EPS2, dt_max=0.0)
    with pytest.raises(RuntimeError, match="stagnated"):
        ta.simulate_adaptive(tb, 1000.0, 1001.0, _tforce, softening_sq=EPS2, dt_max=1e-6,
                             chunk_steps=4)
    _, taken = ta.simulate_adaptive(tb, 0.0, 6.5, _tforce, eta=0.25, softening_sq=EPS2,
                                    dt_max=0.05, chunk_steps=8, max_steps=20)
    assert taken == 24


def test_sure_steps_never_overshoot():
    """The steps run without a host read never arrive: over f32 times near
    t_end, sure_steps x (dt_max plus a rounding) stays short of t_end."""
    for t, t_end, dt_max in ((0.0, 1.0, 0.01), (1000.0, 1000.5, 1e-4), (0.0, 1e-3, 1e-3),
                             (5.0, 5.0, 0.1)):
        s = ta.sure_steps(t, t_end, dt_max, torch.float32)
        tt = np.float32(t)
        for _ in range(s):
            assert t_end - float(tt) > dt_max
            tt = np.float32(tt + np.float32(dt_max))
    assert ta.sure_steps(0.0, float("nan"), 0.1, torch.float32) == 0


def test_cli_adaptive_matches_jax_cli(tmp_path, capsys):
    """tests/test_adaptive.py:127-142 on both CLIs (plain paths, f64): the
    same 'Adaptive steps taken:' count and frames within 1e-6."""
    src = os.path.join(DATA_DIR, "10_bodies.csv")
    argv = ["0", "1", "0.1"]
    flags = ["--adaptive-eta", "0.01", "--softening2", "1e-4", "--dtype", "f64"]
    out_t, out_j = tmp_path / "t.csv", tmp_path / "j.csv"
    assert main([src, *argv, str(out_t), "--device", "cpu", "--backend", "torch",
                 *flags]) == 0
    said_t = capsys.readouterr().out
    assert jax_main([src, *argv, str(out_j), "--backend", "jnp", *flags]) == 0
    said_j = capsys.readouterr().out
    steps = [int(s.split("Adaptive steps taken:")[1].split()[0]) for s in (said_t, said_j)]
    assert steps[0] == steps[1] > 10
    rows_t, n = read_trajectory(out_t)
    rows_j, _ = read_trajectory(out_j)
    assert rows_t.shape == rows_j.shape == ((steps[0] + 1) * n, 5)
    np.testing.assert_allclose(rows_t, rows_j, atol=1e-6, rtol=0)
