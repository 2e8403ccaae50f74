"""The port's timers (nbody_tpu_torch/diag/timing.py, diag/bh_phases.py) on
the CPU: twins of tests/test_tools.py's Stopwatch and pairs_per_sec checks,
and both phase breakdowns at a small n."""

import os

import numpy as np
import pytest
import torch

from nbody_tpu_torch.diag import bh_phases
from nbody_tpu_torch.diag.timing import Stopwatch, pairs_per_sec, trace
from nbody_tpu_torch.utils.fixtures import random_cloud


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs a worker per core, and torch's
    default of a thread per core in every worker oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_stopwatch_and_pairs_per_sec():
    """tests/test_tools.py:82-86, plus the fence on a result and the
    accumulation over calls."""
    sw = Stopwatch()
    with sw.phase("work"):
        sum(range(1000))
    with sw.phase("work", result=torch.ones(3)):
        pass
    with sw.phase("other") as box:
        box["out"] = (torch.zeros(2),)
    assert sw.counts == {"work": 2, "other": 1}
    assert "work" in sw.report() and "x2" in sw.report()
    assert pairs_per_sec(100, 9, 2.0) == 100 * 100 * 10 / 2.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(None):
        torch.ones(4).sum()
    with trace(str(tmp_path / "t")):
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "t" / "trace.json") > 0


def _bodies(n=600):
    c = torch.as_tensor(random_cloud(n, seed=2), dtype=torch.float32)
    return c[:, :3].contiguous(), c[:, 6].contiguous()


@pytest.mark.parametrize("fn,phases", [
    (bh_phases.fused_phase_times, ["sort", "grid", "group", "kernel", "scatter"]),
    (bh_phases.flat_phase_times, ["sort+build+group", "traverse", "eval", "scatter"]),
])
def test_phase_times_and_report(fn, phases):
    """Every phase of one evaluation and the whole call, in that order,
    positive; the report prints each in ms and the phases' sum over the
    whole."""
    pos, mass = _bodies()
    kw = dict(G=1.0, softening_sq=0.01, theta=0.5, reps=1)
    if fn is bh_phases.flat_phase_times:
        kw["list_size"] = 2048
    else:
        kw["group_size"] = 128
    times = fn(pos, mass, **kw)
    assert list(times) == [*phases, "TOTAL (one call)"]
    assert all(v > 0 for v in times.values())
    text = bh_phases.report(times).splitlines()
    assert len(text) == len(times) + 1
    ratio = float(text[-1].split()[-1])
    parts = sum(times[p] for p in phases)
    assert np.isclose(ratio, parts / times["TOTAL (one call)"], rtol=1e-3, atol=1e-3)
