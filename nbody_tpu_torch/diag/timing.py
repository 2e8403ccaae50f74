"""Per-phase timing and throughput metrics — counterpart of
``nbody_tpu/diag/timing.py``.

The reference instruments with wall-clock around propagation
(serial/exhaustive.c:59-68), per-kernel timers behind -DPRINT_KERNEL_TIME
(cuda/barnes-hut.cu:938-948, 1040-1049) and per-step progress prints
behind PRINT_LOOP (:9, 1037-1039).  Here:

* ``Stopwatch``: named phase timers, each fenced with
  ``torch.cuda.synchronize`` when the phase's result lies on the card (a
  CUDA call returns before the device finishes);
* ``pairs_per_sec``: the all-pairs throughput the CLI and the benchmarks
  report, (steps + 1) · N² pairs;
* ``trace``: a ``torch.profiler`` trace of the CPU and, where there is a
  card, the device, written to a directory as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


def fence(x) -> None:
    """Wait for the device that holds `x` (a tensor or a tuple, list or
    dict of them; the first tensor found decides), so a host clock read
    after it covers the work that made `x`.  No-op on the CPU."""
    for t in _tensors(x):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        return


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


class Stopwatch:
    """Accumulating named phase timers (fenced)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        """Time the block; the fence waits for `result`, or for what the
        block puts in the yielded dict under "out"."""
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            out = box.get("out", result)
            if out is not None:
                fence(out)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {tot:.3f} s total, {tot / n * 1e3:.1f} ms/call x{n}")
        return "\n".join(lines)


def pairs_per_sec(n_bodies: int, n_steps: int, elapsed_s: float) -> float:
    """All-pairs interaction throughput: N² pairs per force call, (steps +
    1) calls per run (the initial call, serial/exhaustive.c:206)."""
    return float(n_bodies) ** 2 * (n_steps + 1) / elapsed_s


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """``torch.profiler`` trace of the block, CPU and CUDA activity where
    there is a card, written to `trace_dir`/TRACE_FILE as a Chrome trace;
    no-op when `trace_dir` is None or empty."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
