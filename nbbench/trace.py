"""The traced run's device timeline: ``torch.profiler`` (CUPTI) over a fixed
number of jobs, reduced to a kernel table.

The profiler records CPU operations and the device's kernels, copies and
sets over `jobs` jobs, after one job it runs and discards (CUPTI's start-up).
Each job is marked by a ``record_function`` span named ``nbbench.job``; the
traced window runs from the first marked job's start to the last one's end.
``reduce`` reads the exported Chrome trace and returns what the per-layer
readers take: each kernel's name, start and duration within the window,
the seconds in which any device operation ran (the union of their
intervals), and the breakdown of the result line.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field

JOB_SPAN = "nbbench.job"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


@dataclass
class Timeline:
    kernels: list  # (name, start_s, dur_s), start from the window's start
    window_s: float
    busy_s: float
    device_ops: list = field(default_factory=list)  # [[name, seconds]] top 10
    idle_gaps: list = field(default_factory=list)  # [[host activity, seconds]] top 10


class Tracer:
    """Profiles `jobs` jobs after one discarded one: call ``step()`` after
    each job; ``active`` says whether the next job is profiled at all."""

    def __init__(self, jobs: int):
        import torch

        self.dir = tempfile.mkdtemp(prefix="nbbench-trace-")
        self.path = os.path.join(self.dir, "trace.json")
        self.left = jobs + 1
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(
            activities=[act.CPU, act.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=jobs, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(self.path))
        self.prof.start()

    @property
    def active(self) -> bool:
        return self.left > 0

    def span(self):
        import contextlib

        import torch

        return torch.profiler.record_function(JOB_SPAN) if self.active else contextlib.nullcontext()

    def step(self) -> None:
        if self.left > 0:
            self.left -= 1
            self.prof.step()
            if self.left == 0:
                self.prof.stop()

    def close(self) -> Timeline:
        if self.left > 0:
            self.left = 0
            self.prof.stop()
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)
        return reduce(events)


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name[len("void "):] if name.startswith("void ") else name
    return name.replace("(anonymous namespace)::", "")[:160]


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list) -> Timeline:
    """The kernel table, busy time and breakdown of a Chrome trace's events
    (timestamps in microseconds) within the window of its job spans."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == JOB_SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError("the trace holds no job span")
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and t0 <= e["ts"] < t1]
    kernels = [(e["name"], (e["ts"] - t0) * 1e-6, e["dur"] * 1e-6)
               for e in dev if e["cat"] == "kernel"]
    busy = _union([(e["ts"], min(e["ts"] + e["dur"], t1)) for e in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    by_name: dict = {}
    for name, _, dur in kernels:
        by_name[_short(name)] = by_name.get(_short(name), 0.0) + dur
    for e in dev:
        if e["cat"] != "kernel":
            by_name[e["cat"]] = by_name.get(e["cat"], 0.0) + e["dur"] * 1e-6
    device_ops = sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("name") != JOB_SPAN and not e.get("name", "").startswith("ProfilerStep")]
    gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
    if busy:
        gaps += [(t0, busy[0][0]), (busy[-1][1], t1)]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:10]
    idle = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        under = [e for e in host if e["ts"] <= mid < e["ts"] + e["dur"]]
        what = (min(under, key=lambda e: e["dur"])["name"] if under
                else "host between operations")
        idle.append([what, (b - a) * 1e-6])
    return Timeline(kernels=kernels, window_s=(t1 - t0) * 1e-6, busy_s=busy_s,
                    device_ops=device_ops, idle_gaps=idle)
