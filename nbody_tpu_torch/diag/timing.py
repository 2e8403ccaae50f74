"""Per-phase timing, spans and throughput metrics — counterpart of
``nbody_tpu/diag/timing.py``.

The reference instruments with wall-clock around propagation
(serial/exhaustive.c:59-68), per-kernel timers behind -DPRINT_KERNEL_TIME
(cuda/barnes-hut.cu:938-948, 1040-1049) and per-step progress prints
behind PRINT_LOOP (:9, 1037-1039).  Here:

* ``span(name)``: a span at one of the port's layer boundaries (or
  ``spanned(name)``, a function's every call), and ``host_sync(site)``,
  the span ``host_sync.<site>`` around a point where the host waits for
  the device or the CUDA runtime (its count is the count of host syncs).  They record only while a ``torch.profiler`` records
  (``--trace``, or a profiler of the caller's); otherwise a span costs one
  flag check.  A recorded span is a ``record_function`` range, so it shows
  in the profiler's trace as a ``user_annotation`` event on the clock of
  the device's kernels and copies; the recorder keeps its name, parent,
  root (the outermost span open at its start: a probe or a run) and host
  start and end (``time.time_ns``, the trace's clock), and on the card
  its device time between two CUDA events, read only when ``summary()``
  is.  Nothing synchronizes while spans record.
* ``mark``/``seconds``: a point on the device's timeline (a CUDA event,
  or the host clock on the CPU) and the seconds between two, so an
  interval includes the gaps in which the device waits for its launches
  (``diag/bh_phases.py`` and the spans);
* ``pairs_per_sec``: the all-pairs throughput the CLI and the benchmarks
  report, (steps + 1) · N² pairs;
* ``trace``: a ``torch.profiler`` trace of the CPU and, where there is a
  card, the device, written to a directory as a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import time

import torch

_profiling = torch.autograd._profiler_enabled
_CUDA = torch.device("cuda")

# completed spans kept for ``spans()``; the per-name sums hold every one
RECENT_SPANS = 65536
# pairs of CUDA events left unread before the oldest finished ones are read
PENDING_EVENTS = 4096


def mark(device: torch.device):
    """A point on `device`'s timeline: a CUDA event recorded on the current
    stream, or the host clock off the card."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def seconds(a, b) -> float:
    """Seconds from mark `a` to mark `b` (events: both recorded, `b`
    finished)."""
    return b - a if isinstance(a, float) else a.elapsed_time(b) * 1e-3


class _Open:
    __slots__ = ("id", "name", "parent", "root", "t0", "rf", "ev")

    def __init__(self, sid, name, parent, root, t0, rf, ev):
        self.id, self.name, self.parent, self.root = sid, name, parent, root
        self.t0, self.rf, self.ev = t0, rf, ev


class Recorder:
    """The spans recorded in one process: per name their count, host
    seconds and device seconds, and the last RECENT_SPANS spans whole."""

    def __init__(self) -> None:
        self._ids = itertools.count(1)
        self._stack: list = []
        self.clear()

    def clear(self) -> None:
        """Forget every completed span (open ones still complete)."""
        self._totals: dict = {}  # name -> [count, host ns, device s]
        self._pending: collections.deque = collections.deque()  # (name, ev0, ev1)
        self._recent: collections.deque = collections.deque(maxlen=RECENT_SPANS)

    def enter(self, name: str) -> _Open:
        t0 = time.time_ns()
        rf = torch.autograd.profiler.record_function(name)
        rf.__enter__()
        ev = mark(_CUDA) if torch.cuda.is_initialized() else None
        parent = self._stack[-1] if self._stack else None
        sid = next(self._ids)
        rec = _Open(sid, name, parent.id if parent else None, parent.root if parent else sid,
                    t0, rf, ev)
        self._stack.append(rec)
        return rec

    def exit(self, rec: _Open) -> None:
        ev1 = mark(_CUDA) if rec.ev is not None else None
        rec.rf.__exit__(None, None, None)
        t1 = time.time_ns()
        self._stack.pop()
        tot = self._totals.get(rec.name)
        if tot is None:
            tot = self._totals[rec.name] = [0, 0, None]
        tot[0] += 1
        tot[1] += t1 - rec.t0
        self._recent.append((rec.id, rec.name, rec.parent, rec.root, rec.t0, t1))
        if ev1 is not None:
            self._pending.append((rec.name, rec.ev, ev1))
            if len(self._pending) > PENDING_EVENTS:
                self._resolve(wait=False)

    def _resolve(self, wait: bool) -> None:
        """Add the device seconds of the pending spans whose events have
        finished, oldest first; all of them, waiting, with `wait`."""
        while self._pending:
            name, ev0, ev1 = self._pending[0]
            if wait:
                ev1.synchronize()
            elif not ev1.query():
                return
            self._pending.popleft()
            tot = self._totals[name]
            tot[2] = (tot[2] or 0.0) + seconds(ev0, ev1)

    def summary(self) -> dict:
        """{name: {"count", "host_s", "device_s"}} over the spans completed
        since the last ``clear``; device_s is None where no span of the
        name ran on the card.  Waits for the device's pending spans."""
        self._resolve(wait=True)
        return {name: {"count": c, "host_s": ns * 1e-9, "device_s": dev}
                for name, (c, ns, dev) in self._totals.items()}

    def spans(self) -> list:
        """The last RECENT_SPANS completed spans, in order of completion:
        (id, name, parent id or None, root id, start ns, end ns)."""
        return list(self._recent)


RECORDER = Recorder()


class span:
    """``with span(name):`` records the block as span `name` while a
    ``torch.profiler`` records, and costs one flag check otherwise."""

    __slots__ = ("name", "_rec")

    def __init__(self, name: str) -> None:
        self.name = name
        self._rec = None

    def __enter__(self):
        if _profiling():
            self._rec = RECORDER.enter(self.name)

    def __exit__(self, *exc) -> None:
        if self._rec is not None:
            RECORDER.exit(self._rec)
            self._rec = None


def spanned(name: str):
    """A decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def host_sync(site: str) -> span:
    """The span ``host_sync.<site>``, around one point where the host waits
    for the device or the CUDA runtime."""
    return span("host_sync." + site)


def summary() -> dict:
    """The recorder's per-name table (``Recorder.summary``)."""
    return RECORDER.summary()


def clear() -> None:
    RECORDER.clear()


def report(table: dict | None = None) -> str:
    """One line a span name, by host time: count, host ms, device ms."""
    table = summary() if table is None else table
    if not table:
        return "spans: none recorded"
    width = max(len(k) for k in table)
    lines = [f"  {'span':<{width}}  {'count':>7}  {'host ms':>11}  {'device ms':>11}"]
    for name, v in sorted(table.items(), key=lambda kv: -kv[1]["host_s"]):
        dev = "-" if v["device_s"] is None else f"{v['device_s'] * 1e3:11.3f}"
        lines.append(f"  {name:<{width}}  {v['count']:7d}  {v['host_s'] * 1e3:11.3f}  {dev:>11}")
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
