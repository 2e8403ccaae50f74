"""Run one benchmark cell once and print its result as the last line.

    python3 -m nbbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run loads the port, draws the cell's pool of inputs on the card from
`--seed`, warms up with two jobs, then runs jobs back to back (a closed
loop, one client) for `--seconds`: job j takes input j mod pool, runs the
CLI's path for it (``program.py``) and ends in the copy of its answer to
the host.  Each job is timed by the host clock.  After the window it
compares a sample of the jobs' answers, drawn from the seed, with the plain
reference (``reference.py``, ``check.py``), and prints one JSON line: the
cell's end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`, which profiles the window's first jobs (``trace.py``).

It needs a CUDA card and never falls back to the CPU; it imports nothing
of JAX or of the JAX package.  The port builds its kernels into
``nbody_tpu_torch/_build/`` inside the checkout, the first run only.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from nbbench import check, gen, program, reference, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nbody_tpu")  # top-level module names
WARMUP_JOBS = 2
TRACE_JOBS = 10


@dataclass
class WindowCtx:
    """What an end-to-end reader takes."""

    durations: list
    window_s: float
    setup_s: float
    n: int
    steps_per_job: int


@dataclass
class TraceCtx:
    """What a per-layer reader takes."""

    timeline: object  # trace.Timeline
    durations: list  # the host-clock seconds of the window's jobs not profiled
    kind: str
    config: dict
    cell: dict
    counters: dict  # the port's counters, summed over the traced jobs
    jobs: list  # the pool index of each traced job
    inputs: list  # the pool
    steps: int  # KDK steps of the traced jobs
    n: int


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``nbody_tpu_torch`` is not ``nbody_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, *, bench: dict,
             cell: dict | None = None, config: dict | None = None, extra=(),
             wrap_job=None) -> dict:
    """One run of workload `name` on `device`; returns the result line's
    object.  `cell`/`config` replace the files' (the CPU tests shrink them),
    `extra` adds CLI flags, `wrap_job(job) -> job` replaces the timed job
    (the tests break it)."""
    import torch

    cell = cell or spec.cell(name)
    config = config or spec.config(cell["config"])
    cuda = device.type == "cuda"
    pool = gen.make_pool(cell["distribution"], config["n"], cell["pool"], seed,
                         cell["dtype"], device)
    prog = program.build(config, cell, device, pool[0], tuple(extra))
    job = wrap_job(prog.job) if wrap_job else prog.job
    print(f"nbbench: {name} seed {seed}: {prog.label}, n {config['n']}, pool {len(pool)}",
          file=sys.stderr)

    for i in range(WARMUP_JOBS):
        job(*pool[i % len(pool)])
    # the objects of the imports and the set-up are never collected: keep
    # the collector's full passes over them out of the window
    gc.collect()
    gc.freeze()
    tracer = None
    if trace:
        from nbbench.trace import Tracer

        tracer = Tracer(TRACE_JOBS)

    # the window: jobs back to back until `seconds` have passed
    rng = random.Random(seed)
    keep = int(cell.get("check_jobs", 2))
    sample = []  # (pool index, answer): a uniform sample of the jobs
    durations, failures = [], []
    traced, before, after = [], {}, None
    plain = []  # the durations of the jobs the profiler did not record
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    t_last = t0
    k = 0
    while t_last - t0 < seconds or (tracer is not None and tracer.active):
        p = k % len(pool)
        profiled = tracer is not None and tracer.active
        if profiled and tracer.left == TRACE_JOBS:  # the first job recorded
            before = prog.counters()
        ta = time.perf_counter()
        try:
            with tracer.span() if profiled else contextlib.nullcontext():
                out = job(*pool[p])
        except Exception as e:  # a job that raises is a failed operation
            failures.append(f"job {k}: {type(e).__name__}: {e}")
            out = None
        t_last = time.perf_counter()
        if profiled:
            if tracer.left <= TRACE_JOBS:
                traced.append(p)
            tracer.step()
            if not tracer.active:
                after = prog.counters()
        if out is not None:
            durations.append(t_last - ta)
            if not profiled:
                plain.append(t_last - ta)
            slot = k if k < keep else rng.randrange(k + 1)
            if slot < keep:
                if slot < len(sample):
                    sample[slot] = (p, out)
                else:
                    sample.append((p, out))
        k += 1
    window_s = t_last - t0
    attempted = k

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"nbbench: forbidden modules loaded: {bad}")

    device_obj = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                  "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        timeline = tracer.close()
        counters = {key: after[key] - before[key] for key in after}
        ctx = TraceCtx(timeline=timeline, durations=plain, kind=kind, config=config, cell=cell,
                       counters=counters, jobs=traced, inputs=pool,
                       steps=len(traced) * int(cell["steps_per_job"]), n=config["n"])
        section = "per_layer"
        device_obj.update(busy_s=timeline.busy_s, window_s=timeline.window_s)
        breakdown = {"device_ops": timeline.device_ops, "idle_gaps": timeline.idle_gaps}
    else:
        ctx = WindowCtx(durations=durations, window_s=window_s, setup_s=setup_s,
                        n=config["n"], steps_per_job=int(cell["steps_per_job"]))
        section = "end_to_end"
    metrics = {}
    for m in spec.metrics(bench, section, name):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: the sampled answers against the reference, the program's
    # state freed and the memory peak read
    del job, prog
    if cuda:
        torch.cuda.empty_cache()
    refs, readings = {}, []
    for p, out in sample:
        if p not in refs:
            r = reference.job(config, cell, *pool[p], mode=cell["dtype"])
            refs[p] = tuple(t.double().cpu().numpy() for t in r)
        start = (pool[p][0].double().cpu().numpy(), pool[p][1].double().cpu().numpy())
        readings.append(check.gaps(out, refs[p], start))
    correct, shown = check.judge(readings, cell["limits"], len(failures))

    result = {"correct": correct, "attempted": attempted, "failed": len(failures),
              "metrics": metrics, "device": device_obj}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = shown
    for f in failures[:5]:
        print(f"nbbench: failed {f}", file=sys.stderr)
    if durations:
        d = sorted(durations)
        q = {f"p{int(100 * f)}": d[min(len(d) - 1, int(f * len(d)))] for f in (0, .5, .9, .99)}
        parts = [sorted(durations[i * len(durations) // 6:(i + 1) * len(durations) // 6])
                 for i in range(6)]
        print(f"nbbench: job seconds {q}, max {d[-1]:.4f}; median of each sixth of the "
              f"window {[round(x[len(x) // 2], 4) for x in parts if x]}", file=sys.stderr)
    print(f"nbbench: {attempted} jobs in {window_s:.3f} s, set-up {setup_s:.3f} s, "
          f"{len(readings)} checked, card {kind}, power limit "
          f"{power_limit() if cuda else 'n/a'}", file=sys.stderr)
    for key, v in shown.items():
        print(f"check {key} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    entry = spec.workload(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"nbbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    import nbody_tpu_torch

    if not os.path.abspath(nbody_tpu_torch.__file__).startswith(spec.ROOT + os.sep):
        print(f"nbbench: nbody_tpu_torch is not this checkout's ({nbody_tpu_torch.__file__})",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"nbbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
