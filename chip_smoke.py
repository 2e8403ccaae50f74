#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nbody_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

It drives the port's paths through the hand-written CUDA kernels and
checks them: the default all-pairs CLI run (100k bodies x 10 KDK steps in
f32 with --energy), the fused Barnes-Hut run (--algo auto at 1M bodies, 5
KDK steps, f32, --energy), both again with --dtype f64, the list-based
Barnes-Hut run (--bh-traversal flat at 1M bodies, 5 KDK steps, f32 and
f64), the tensor-core all-pairs kernel, and the robust Barnes-Hut run
(--algo auto on a 1M Plummer sphere with escapers, f32 and f64), the
persistent Morton layout (--resort-every, plain and robust), and the run
options checkpoint/resume, adaptive dt, merging and block time-step
tiers.  Phases (each raises on failure, so the script exits non-zero and
prints no result):

1. card and build: nvidia-smi's name and power limit, nvcc's version, the
   kernels built from nbody_tpu_torch/csrc/*.cu for sm_90a and the build
   time and ptxas report; each kernel's SASS floating-point instructions,
   per MUFU.RSQ64H (fp64) and per MUFU.RSQ (fp32): its instructions a pair,
   over the whole kernel and over its hot loop (all issued ones there);
2. all-pairs kernel against its plain PyTorch twin at the main path's
   shape (100k x 100k), at n=4096, at an unaligned 100,003 x 4,099, in
   per-body mode, and the CLI on the 10-body reference golden file;
3. potential-energy kernel against its twin and the plain fp64 PE at 100k
   and at a ragged 5,003 with coincident pairs in one tile and across row
   blocks and tiles, bit-identical reruns;
4. the main path: ``nbody_tpu_torch.cli.main.main`` in-process, with the
   kernel launch counters reset just before and read just after;
5. the same run with ``--backend torch`` (plain PyTorch on the card):
   final positions and energy drift must agree;
6. kernel times beside the plain versions (CUDA events), and pairs/s of
   both backends, each printed beside the card's name and power limit;
   the SM clock and power draw under K1; K1 at every number of source
   slices a block on the main path's 100k x 100k and on the 100,003 x
   4,099 and 1M x 1,953 rectangles, each held against its plain version
   with bit-identical reruns, beside its time before the redesign, its
   bound and its fp32 issue floor; K3 at 100k and
   at 1M beside its time before the redesign, its bound on the unordered
   pairs, its fp32 issue and MUFU floors and its plain version's time, and
   at 1M against its twin and the plain fp64 PE (which [18] also takes);
7. the fused Barnes-Hut kernel (K6) against its plain twin on the same
   tables and groups, at 100k and at the main path's 1M: K1's bound, equal
   stats, bit-identical reruns;
8. the whole fused Barnes-Hut call against exact all-pairs forces (K1) on
   the reference's 1M uniform cloud (seed 0);
9. the Barnes-Hut main path: the 1M cloud written to CSV, then
   ``--algo auto --energy --write-every 5`` over 5 steps in-process, with
   the launch counters reset just before and read just after;
10. the same run with ``--algo exhaustive`` (K1): final positions and
    energy drift must agree;
11. K6 and its twin at 100k and 1M, the 1M call split into sort+build, K6
    and scatter, and s/step of both algorithms at 1M with --no-output;
12. the fp64 all-pairs kernel (K4) against its plain version at 100k x 100k,
    at 100,003 x 4,099 and at 1M x 1,953 (one source slice a block), and
    against the fp64 formula on a subset of targets, bit-identical reruns;
13. the fp64 potential-energy kernel (K5) against its plain version at
    100k and at a ragged 5,003 with coincident pairs in one tile and across
    row blocks and tiles, bit-identical reruns;
14. K6's df mode against its plain version on the same f64 tables and
    groups, at 100k, 1M and on the robust input at ld 8: equal stats,
    bit-identical reruns; the base pieces in slot order and heaviest
    first give the wrapper's bits, a group running as several pieces;
15. the f64 all-pairs main path: 100k x 10 KDK steps, --dtype f64
    --energy, counters reset just before and read just after; then the
    same steps in-process through the kernel and through the plain
    backend's force, whose final positions and drifts must agree;
16. the f64 Barnes-Hut main path: --algo auto --dtype f64 --energy at 1M
    over 5 steps, counters reset just before and read just after; the df
    forces against K4's exact ones; s/step beside the f32 run's;
17. the fp64 sun-earth run (SI units, 8640 steps) through K4: drift;
18. fp64 kernel times beside the plain versions, the times before the
    redesign and the bounds (K6 df on the robust input too; K5 at 100k and
    1M with its fp64 issue floor, and at 1M against the plain fp64 PE of
    [6]), the SM clock
    and power draw under K4, K4 at every number of source slices, K6 df's
    unpriced full kernel over the base pieces in slot order, and f64
    s/step at 100k;
19. the group x interaction-list kernel (K7, both entry points) against its
    plain version on the lists the flat traversal builds: f32 at 100k and
    1M, fp64 at 100k and 1M; bit-identical reruns; issued slot-pairs;
20. the list path (barneshut_accelerations, flat) against [8]'s exact
    forces at 1M; the padded traversal against flat at 100k, and at 1M if
    its capacity probe fits;
21. the list-path main path: --algo barnes-hut --bh-traversal flat
    --energy --write-every 5 at 1M over 5 steps, counters reset just
    before and read just after; drift and final positions against [10]'s
    exhaustive run (a probe that overflows is rerun with the value it
    prescribes);
22. the same run with --dtype f64 through K7's fp64 entry point; its forces
    against K4's exact ones;
23. K7 and its plain version timed at 100k and 1M, with the issue floors
    and both entries' times before their redesign; both entries at every
    number of list slices a block, held against the plain version with
    bit-identical reruns; one 1M list-path evaluation split into
    sort+tree+groups, traversal, K7 and scatter, a torch.profiler trace of
    one evaluation (device busy share, kernel launches, the costliest
    kernels), and --no-output s/step at 1M in turns flat, fused, fused,
    flat (and padded where it fits), then flat with --dtype f64 twice;
24. the tensor-core all-pairs kernel (K2) against its plain version at
    100k x 100k, at 100,003 x 4,099, in per-body mode and on a cloud offset
    from the origin; against K1, and against the fp64 formula on 256
    targets and, with self-terms, on 2,000 bodies with per-body eps2;
    bit-identical reruns; its SASS a pair, issue floor and MUFU floor;
25. the robust Barnes-Hut hybrid (barneshut_fused_robust: K6 + K1) against
    exact forces on a 1M Plummer sphere with 8 escapers at r 300-1000, the
    escapers against their own force scale; near bodies of the plain fused
    path on the same input;
26. the robust main path: that input as CSV, --algo auto --energy
    --write-every 5 over 5 steps, counters reset just before and read just
    after (K6 and K1 7 times each); drift and final positions against the
    --algo exhaustive run of the same file;
27. the same with --dtype f64 (K6 df + K4), its forces against K4's exact
    ones;
28. K2 beside K1 at 100k with K2's bound, its time before the redesign
    and its floors; one robust evaluation split into
    box, depth probe, set-up, K6 and the K1 rectangle; the depth pricer's
    unit costs on this card (K6 time against its stats lanes, set-up time
    against the dense-grid nodes); one robust f64 evaluation and K6 df at ld
    5-8; --no-output s/step of the uniform 1M run with --bh-robust off, on,
    on, off;
29. K6's stage cuts (the JAX kernel's debug_mode) and its redesign: the
    registers and spills of every instantiation; on the 100k bodies, the
    1M uniform cloud and the robust input (ld as picked, and 8), every f32
    cut with stats equal to full's (zero in none) and zero forces short of
    full, the full cut bit-identical to the production entry and to the
    heaviest-first launch; ms per cut and the increments, real and issued
    pairs, the source-weighted lane fill, K6's bound and its pairs at K1's
    rate; the df mode's cuts at 100k, 1M and on the robust input, timed;
30. the persistent Morton layout (--resort-every 4) at 1M uniform bodies:
    the CLI run with --energy --write-every 5, counters reset just before
    and read just after, its final positions and drift against [9]'s
    one-shot run; its forces after 4 unsorted steps against exact ones on
    sampled bodies; an evaluation rerun bit-identical; one step split into
    table rebuild, K6, kick and drift, and one resort, beside [11]'s
    one-shot split; --no-output s/step in turns one-shot, persistent,
    persistent, one-shot; the table rebuild at ld 5-8 and its cost per
    dense-grid node (the depth pricer's NS_PER_TABLE_NODE);
31. the robust persistent layout (K6 + K1 every step) on [25]'s input:
    the depth pricer's pick, the first evaluation against exact forces
    (the escapers against their own scale), a rerun bit-identical, one
    step split, the CLI run with counters reset and read, s/step in turns
    beside the one-shot robust run, and the rebuild's fit on this input;
32. --timers on the fused and the flat traversal at 1M (the phases' sum
    over the whole evaluation), a --trace of the 100k run read back for
    its device kernels, and --devices;
33. checkpoint and resume: the 100k run over 10 steps with
    --checkpoint-every 5, and the same run stopped at step 5 and resumed
    from its checkpoint: frames and final state byte-identical; the 1M
    --resort-every 4 run checkpointed at step 4 and resumed, held to [9]'s
    one-shot run within [30]'s bound; the 1M checkpoint's write time;
34. adaptive dt: 100k through K1 against --backend torch (steps taken,
    drift within 5 % of it, and in-process the landing on f32(t_end) and
    the final positions against the plain force's within [30]'s bound),
    and 1M with --resort-every 4 through K6 against the one-shot adaptive
    run (the same checks, the final positions in-process); s/step;
35. merging: a cold 100k clump (equal masses 2^-17) with --merge-radius
    through K1, the plain backend and the persistent layout (K6): merged
    counts equal, mass conserved exactly, momentum to rounding, the
    ghosts in the frames' mass column; one merge pass timed;
36. block tiers on the stratified 1M input (a hot Plummer core in a cold
    halo): the tier histogram, --block-tiers 3 masked and --block-prefix
    through the CLI (final states bit-identical), K6 launches a macro
    step, and ms a macro step in turns masked, prefix, prefix, masked
    beside plain KDK at dt and at dt/4.

Then one JSON line describing the kernels, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CSV_100K = os.path.join(ROOT, "tests", "data", "100k_bodies.csv")
CSV_10 = os.path.join(ROOT, "tests", "data", "10_bodies.csv")
GOLDEN_10 = os.path.join(ROOT, "tests", "data", "golden_exh_10bodies_0_10_0.1.csv")
SUN_EARTH = os.path.join(ROOT, "tests", "data", "sun_earth.csv")
STEPS = 10
MAIN_WINDOW = ["0", "0.001", "0.0001"]  # C-float step count: 10 steps
ATOL_REL, RTOL = 2e-5, 2e-4  # f32 kernel bound (tests/test_pallas.py:25)
BH_N = 1_000_000  # the reference's Barnes-Hut size (tools/bench_bh.py:4-6)
BH_STEPS, BH_DT = 5, 0.0001
BH_WINDOW = ["0", "0.0005", "0.0001"]  # C-float step count: 5 steps
BH_BOUND = 0.02  # max |a - exact| / max |a| (tests/test_bh_fused.py:51)
F64_BOUND = 1e-12  # fp64 forces, max |err| / max |want| (test_pallas_df.py:47)
F64_PE_BOUND = 1e-13  # fp64 PE, relative (test_pallas_df.py:101)
F64_POS_BOUND = 1e-10  # final positions, kernel against the plain backend

# Least-time bounds (the larger of bytes over the memory rate and operations
# over the peak rate; NVIDIA H100 SXM data sheet, dense, at 700 W):
HBM_BPS = 3.35e12
FP32_PEAK = 67e12  # FLOP/s outside the tensor cores
FP64_PEAK = 34e12  # FLOP/s outside the tensor cores
CLOCK_HZ = 1.98e9  # SM clock of the issue floors: measured under K1 and K4 (PERF.md)
# operations per pair, rsqrt counted as one: the force (3 sub; 3 mul + 3 add
# for |d|^2 + eps2; rsqrt; 2 mul for r^-3; 1 mul by G·m; 3 multiply-adds),
# and the potential energy (3 sub; 3 mul + 2 add for r^2; rsqrt; 1 mul + 1
# add for the row's sum of m_j r^-1, m_i being a factor of the row, not of
# the pair), the latter over the n(n - 1) / 2 unordered pairs, the least
# work for the sum
FORCE_OPS, PE_OPS = 19, 11
MUFU_LANES = 16  # MUFU.RSQ results an SM a clock (NVIDIA throughput table, cc 9.0)
# Kernel times before their redesign, on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md), each measured on the tree before that redesign: K4's and K6
# df's (four targets a thread, pieces of groups), K1's and K7 fp64's
# (targets or slots a thread, split sources), K3's and K5's (the upper
# triangle), K7 f32's and K2's (K1's pair loop, tensor-core B built once a
# tile); the rectangles, K6 df in slot order and K3's and K5's 1M times by
# the profilers of that tree, the rest by this script
BEFORE_MS = {"K4 100k": 15.956, "K4 100003x4099": 0.6608, "K4 1000000x1953": 2.7433,
             "K6 df 100k": 2.3316, "K6 df 1M uniform": 16.1761, "K6 df robust ld 8": 129.2723,
             "K1 100000x100000": 7.0583, "K1 100003x4099": 0.2971, "K1 1000000x1953": 1.2197,
             "K7 fp64 1M": 15.5646, "K3 100k": 6.8840, "K3 1M": 629.4761,
             "K5 100k": 14.9199, "K5 1M": 1292.5297, "K7 f32 1M": 7.2186,
             "K2 100k": 14.8236}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def clock_and_power(torch, fn, samples: int = 5) -> list[str]:
    """nvidia-smi's SM clock and power draw, sampled every 0.25 s while
    `fn` runs over and over."""
    out: list[str] = []

    def sample():
        for _ in range(samples):
            time.sleep(0.25)
            r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=60)
            out.append(r.stdout.strip())

    th = threading.Thread(target=sample)
    th.start()
    while th.is_alive():
        fn()
        torch.cuda.synchronize()
    return out


def f32_close(torch, got, want, what: str) -> float:
    """Check got ~ want within the kernel bound; returns max |got - want|."""
    err = (got - want).abs()
    scale = want.abs().max().item()
    bad = (err > ATOL_REL * scale + RTOL * want.abs()).sum().item()
    max_err = err.max().item() if err.numel() else 0.0
    print(f"  {what}: max |err| {max_err:.3e} (force scale {scale:.3e}, "
          f"bound {ATOL_REL:g}*scale + {RTOL:g}*|want|), {bad} outside")
    check(bad == 0 and bool(torch.isfinite(got).all()), what)
    return max_err


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time for `nbytes` moved and `ops`
    done at `peak` operations per second."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def fused_work(args, stats, real_bytes: int) -> tuple[float, float]:
    """(bytes, operations) K6 must move and do on these inputs: its tables,
    groups and sources read once and its outputs written once; one pair
    per (body, staged source) of each group."""
    tree, gstart, gcount, src, _ = args
    nbytes = (sum(t.numel() * t.element_size() for t in tree)
              + 2 * gstart.numel() * 4 + src.numel() * real_bytes
              + src.shape[0] * 3 * real_bytes + stats.numel() * 4)
    pairs = float((stats[:, 1].double() * gcount.double()).sum().item())
    return nbytes, pairs * FORCE_OPS


SASS_OPS = ("FADD", "FMUL", "FFMA", "DADD", "DMUL", "DFMA", "MUFU.RSQ", "MUFU.RSQ64H",
            "HMMA", "F2F", "F2FP", "FRND")


def sass_counts(nvcc: str, so_path: str) -> dict[str, dict]:
    """Print, for each kernel in the built library, how many of each
    floating-point instruction its SASS holds (cuobjdump -sass), the fp64
    ones per MUFU.RSQ64H and the fp32 ones per MUFU.RSQ: every pair
    evaluation takes exactly one rsqrt, so that ratio is the instructions
    per pair, plus the kernel's few outside its pair loops; and, in the
    hot loop (the innermost loop holding the rsqrt), the fp32 or fp64 and
    all instructions per rsqrt, what the card issues a pair.  Returns
    {"whole": {kernel: Counter}, "loop": {kernel: Counter of its hot
    loop}}, empty where cuobjdump is missing."""
    from nbody_tpu_torch.diag import sass as sa

    out = {"whole": {}, "loop": {}}
    text = sa.cuobjdump_sass(nvcc, so_path)
    if text is None:
        print("  SASS counts: not measured (no cuobjdump beside nvcc)")
        return out
    for fn, instrs in sa.kernels(text).items():
        c = out["whole"][fn] = sa.whole(instrs)
        line = ", ".join(f"{k} {c[k]}" for k in SASS_OPS if c[k])
        for rsq, kind, names in (("MUFU.RSQ64H", "fp64", sa.FP64),
                                 ("MUFU.RSQ", "fp32", sa.FP32)):
            if not c[rsq]:
                continue
            line += (f"; per {rsq[5:]}: " + ", ".join(f"{k} {c[k] / c[rsq]:.2f}" for k in names)
                     + f", all {kind} {sa.per(c, rsq, names):.2f}")
            loop = sa.hot_loop(instrs, rsq)
            if loop:
                out["loop"][fn] = loop
                top = ", ".join(f"{k} {v / loop[rsq]:.2f}" for k, v in loop.most_common(8))
                line += (f"; hot loop per {rsq[5:]}: {kind} {sa.per(loop, rsq, names):.2f}, "
                         f"all issued {sa.per(loop, rsq, None):.2f} ({top})")
        print(f"  SASS {fn}: {line or 'no floating-point instructions'}")
    return out


def fp32_per_rsq(c) -> float:
    """fp32 instructions (FADD, FMUL, FFMA) per MUFU.RSQ of one kernel's
    SASS counts: its fp32 instructions a pair."""
    return (c["FADD"] + c["FMUL"] + c["FFMA"]) / c["MUFU.RSQ"]


def sass_of(counts: dict, part: str, which: str = "whole"):
    """The SASS counts (`which`: "whole" kernel or its hot "loop") of the
    one kernel whose (mangled) name holds `part`, or None."""
    hits = [c for fn, c in counts[which].items() if part in fn]
    return hits[0] if len(hits) == 1 else None


def fp64_per_seed(c) -> float:
    """fp64 instructions (DADD, DMUL, DFMA) per MUFU.RSQ64H of one kernel's
    SASS counts: its fp64 instructions a pair."""
    return (c["DADD"] + c["DMUL"] + c["DFMA"]) / c["MUFU.RSQ64H"]


def issue_floor_ms(per_pair: float, pairs: float, lanes: int, sms: int) -> float:
    """The least time to issue `per_pair` instructions for each of `pairs`
    pairs on `lanes` lanes of each of `sms` SMs at CLOCK_HZ."""
    return per_pair * pairs / (lanes * sms * CLOCK_HZ) * 1e3


def pe_bound(n: int, real: int, peak: float) -> tuple[float, str]:
    """K3's or K5's bound for n bodies of `real`-byte floats: positions and
    masses read once, the fp64 sum written once, PE_OPS a pair over the
    unordered pairs."""
    return bound((n * 4 + 2) * real, n * (n - 1) / 2 * PE_OPS, peak)


def pe_report(name: str, n: int, ms: float, plain: str, floor: str, real: int,
              peak: float, card: str) -> None:
    """Print one PE kernel's time at n bodies beside its time before the
    redesign, its bound and floors, and its plain version's time."""
    before = BEFORE_MS[f"{name} {'1M' if n == BH_N else '100k'}"]
    kb = pe_bound(n, real, peak)
    print(f"  {name} {n}: kernel {ms:.4f} ms ({n * (n - 1) / 2 / ms / 1e-3:.4e} unordered "
          f"pairs/s; before the redesign {before} ms, {ms / before:.3f}x); bound "
          f"{kb[0]:.4f} ms ({kb[1]}, {ms / kb[0]:.2f}x it); {floor}; plain {plain} [{card}]")


def pe_check(fn, plains: dict, pos, mass, bound_rel: float, what: str) -> None:
    """K3 or K5 (`fn`) against its plain versions (`plains`, {name: fn}) on
    a ragged n with coincident pairs in one tile (0, 1) and across row
    blocks and tiles (7, n - 103): within `bound_rel`, finite, reruns
    bit-identical."""
    pos = pos.clone()
    pos[1], pos[-103] = pos[0], pos[7]
    got = fn(pos, mass).item()
    print(f"  {what}, n={pos.shape[0]}, coincident pairs (0, 1) and (7, "
          f"{pos.shape[0] - 103}): kernel {got!r}")
    for name, plain in plains.items():
        want = plain(pos, mass).item()
        rel = abs(got - want) / abs(want)
        print(f"    {name} {want!r}, rel {rel:.3e} (bound {bound_rel:g})")
        check(np.isfinite(got) and rel <= bound_rel, f"{what} against the {name}")
    check(fn(pos, mass).item() == got, f"{what}: reruns are bit-identical")
    print("    two kernel runs bit-identical: True")


def build_phase(torch) -> tuple[str, str, dict]:
    """Phase [1]: the card, and the kernels built from the sources in this
    run, with ptxas's registers and spills and the SASS instruction counts.
    Returns (nvidia-smi line, device name, SASS counts)."""
    from nbody_tpu_torch.ops import _cuda

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} | torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s), "
          f"device 0: {name}")
    nvcc = _cuda.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    print(f"  nvcc: {nvcc}: {ver[-1]}")
    if os.path.isdir(_cuda.BUILD_DIR):  # build from the sources in this run
        for f in os.listdir(_cuda.BUILD_DIR):
            if f.startswith("kernels-"):
                os.remove(os.path.join(_cuda.BUILD_DIR, f))
    t0 = time.perf_counter()
    kernels = _cuda.library()
    build_s = time.perf_counter() - t0
    print(f"  built {os.path.relpath(kernels.path, ROOT)} from "
          f"{[os.path.relpath(s, ROOT) for s in _cuda.sources()]} "
          f"with {' '.join(_cuda.NVCC_FLAGS)}: nvcc {kernels.build_seconds:.2f} s, "
          f"load {build_s:.2f} s")
    for line in kernels.build_log.splitlines():
        if ("ptxas info" in line and ("registers" in line or "Compiling" in line)
                or "spill" in line):
            print("  " + line.strip())
    check(kernels.build_seconds > 0, "the kernels were compiled in this run")
    return card, name, sass_counts(nvcc, kernels.path)


def run_cli(argv: list[str]) -> str:
    """Run the port's CLI in-process; echo and return its stdout."""
    from nbody_tpu_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    print("  | " + text.rstrip().replace("\n", "\n  | "))
    check(rc == 0, f"CLI exit code {rc} for {argv}")
    return text


def cli_number(text: str, label: str) -> float:
    m = re.search(re.escape(label) + r"\s*(\S+)", text)
    check(m is not None, f"CLI printed {label!r}")
    return float(m.group(1))


def load_frames(path: str, n: int, frames: int = STEPS + 1) -> np.ndarray:
    rows = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    check(rows.shape == (frames * n, 5), f"{path}: {rows.shape} rows")
    check(bool(np.isfinite(rows).all()), f"{path}: finite values")
    frames = rows.reshape(frames, n, 5)
    check(bool((frames[:, :, 0] == np.arange(n)).all()), f"{path}: body ids")
    return frames


def run_cli_rc(argv: list[str]) -> tuple[int, str, str]:
    """Run the port's CLI in-process; echo and return (exit code, stdout,
    stderr)."""
    from nbody_tpu_torch.cli.main import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    for label, buf in (("|", out), ("!", err)):
        if buf.getvalue():
            print(f"  {label} " + buf.getvalue().rstrip().replace("\n", f"\n  {label} "))
    return rc, out.getvalue(), err.getvalue()


def timed_once(torch, fn):
    """(result, device ms) of one call of `fn`, with CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def lists_work(gl, real_bytes: int, split: int) -> tuple[float, float, float, float]:
    """(bytes, operations, real pairs, issued slot-pairs) of one K7 call
    on these lists: each group's list rows up to its length read once, the
    slot positions read once and the accelerations written once, the
    lengths read once; one pair per (real body, list row up to the
    length); with `split` list slices a block of 512 / split slots, the
    kernel computes ceil(B / (512 / split)) * 512 / split slots per group,
    each against the group's length."""
    n_groups, b, _ = gl.pg.shape
    lengths = gl.lengths.double()
    count = gl.group_valid.sum(1).double()
    rows = float(lengths.sum().item())
    pairs = float((count * lengths).sum().item())
    chunk = 512 // split
    issued = float(-(-b // chunk) * chunk) * rows
    nbytes = rows * 4 * real_bytes + 2 * n_groups * b * 3 * real_bytes + n_groups * 4
    return nbytes, pairs * FORCE_OPS, pairs, issued


def list_phases(torch, dev, card: str, sass: dict, arr, arr1m, csv1m: str, tmp: str,
                exact1m, frames_ex, drift_ex: float, drift_bh32: float) -> list[dict]:
    """Phases [19]-[23]: K7 and the list-based Barnes-Hut path.  Returns
    K7's entries of the JSON line."""
    from nbody_tpu_torch.core.capacity import CapacityError
    from nbody_tpu_torch.core.types import Bodies
    from nbody_tpu_torch.ops import _cuda, barneshut, bh_fused, bh_fused_df, cuda_lists
    from nbody_tpu_torch.ops.cuda_exhaustive import (
        cuda_potential_energy,
        cuda_rect_accelerations,
    )
    from nbody_tpu_torch.ops.cuda_fp64 import (
        cuda_accelerations_f64,
        cuda_potential_energy_f64,
        cuda_rect_accelerations_f64,
    )

    f32, f64 = torch.float32, torch.float64
    n = arr.shape[0]
    bodies = {(n, f32): Bodies.from_numpy(arr, dtype=f32, device=dev),
              (BH_N, f32): Bodies.from_numpy(arr1m, dtype=f32, device=dev),
              (n, f64): Bodies.from_numpy(arr, dtype=f64, device=dev),
              (BH_N, f64): Bodies.from_numpy(arr1m, dtype=f64, device=dev)}
    wrappers = {f32: cuda_lists.eval_lists, f64: cuda_lists.eval_lists_f64}

    # 19. K7 against its plain version on the flat traversal's lists
    print("[19] group x interaction-list kernel K7 (nbody_tpu_torch/csrc/group_lists.cu)")
    k7 = {}  # (n, dtype) -> (group lists, max |err|, plain ms)
    k7_want = {}  # (n, dtype) -> the plain version's accelerations
    sms = _cuda.sm_count(dev)
    for (nb, dtype), bd in bodies.items():
        gl = barneshut.group_lists(bd.pos, bd.mass)
        st = [int(x) for x in gl.stats]
        need = st[0]
        print(f"  n={nb} {dtype}: {gl.pg.shape[0]} group slots, B {gl.pg.shape[1]}, "
              f"{int((gl.lengths > 1).sum())} groups with lists > 1 row, stats "
              f"(list, frontier excess, ranges excess, terminal COM) {st}")
        check(st[1] == 0 and st[2] == 0, "flat traversal frontier and stores fit")
        if need > gl.lists.shape[1]:
            print(f"  lists need {need} rows, over the default 16384: rebuilt with "
                  f"list_size={need}")
            gl = barneshut.group_lists(bd.pos, bd.mass, list_size=need)
        wrap = wrappers[dtype]
        got = wrap(gl.pg, gl.lists, gl.lengths, eps2=0.01)
        want, plain_ms = timed_once(torch, lambda: cuda_lists.eval_lists_reference(
            gl.pg, gl.lists, gl.lengths, eps2=0.01))
        what = f"n={nb}, M {gl.lists.shape[1]}"
        if dtype == f32:
            err = f32_close(torch, got, want, what)
        else:
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            print(f"  {what}: max |err| {err:.3e}, force scale {scale:.4e}, rel "
                  f"{err / scale:.3e} (bound {F64_BOUND:g})")
            check(err <= F64_BOUND * scale and bool(torch.isfinite(got).all()),
                  "K7 fp64 against its plain version")
        k7_want[nb, dtype] = want
        check(torch.equal(wrap(gl.pg, gl.lists, gl.lengths, eps2=0.01), got),
              "K7 reruns are bit-identical")
        split = cuda_lists.k7_split(*gl.pg.shape[:2], sms)
        _, _, pairs, issued = lists_work(gl, 4, split)
        jax_grid = float(gl.pg.shape[0] * gl.pg.shape[1] * gl.lists.shape[1])
        print(f"  two kernel runs bit-identical: True; real pairs {pairs:.4e}, issued "
              f"slot-pairs {issued:.4e} ({split} list slices), JAX's grid G*B*M "
              f"{jax_grid:.4e}; plain version one run {plain_ms:.4f} ms [{card}]")
        k7[nb, dtype] = (gl, err, plain_ms)
    list_1m = k7[BH_N, f32][0].lists.shape[1]

    # 20. the list path against exact forces at 1M; padded against flat
    print(f"[20] barneshut_accelerations (flat, K7) against exact all-pairs forces, "
          f"{BH_N} bodies")
    b1m = bodies[BH_N, f32]
    acc, stats = barneshut.barneshut_accelerations(b1m.pos, b1m.mass, list_size=list_1m,
                                                   return_stats=True)
    torch.cuda.synchronize()
    print(f"  BHStats: {dict((k, int(v)) for k, v in stats.traverse._asdict().items())}, "
          f"list capacity {stats.list_capacity}, frontier capacity "
          f"{stats.frontier_capacity}, range capacity {stats.range_capacity}; "
          f"overflowed {stats.overflowed()}")
    check(not stats.overflowed(), "the flat traversal fits at 1M")
    dlist = (acc - exact1m).abs().max().item()
    rel = dlist / exact1m.abs().max().item()
    med = ((acc - exact1m).norm(dim=1) / exact1m.norm(dim=1)).median().item()
    print(f"  max |a - exact| / max |a| = {rel:.4e} (bound {BH_BOUND}); median "
          f"|a - exact| / |exact| = {med:.4e}; max |a - exact| {dlist:.4e}")
    check(rel < BH_BOUND and bool(torch.isfinite(acc).all()),
          "the list path within 0.02 of exact forces at 1M")
    padded_default_fits = {}  # n -> whether the padded probe fits the defaults
    for nb in (n, BH_N):
        bd = bodies[nb, f32]
        kw = {"list_size": list_1m}
        for attempt in range(4):
            check(attempt < 3, "the padded probe fits the sizes it prescribes")
            try:
                barneshut.check_capacities(bd.pos, bd.mass, traversal="padded", **kw)
                break
            except CapacityError as e:
                # a finding, not a failure: run with the sizes it names
                print(f"  padded at n={nb}, {kw}: the probe overflows: {e}")
                for key in ("list_size", "frontier_size", "range_size"):
                    m = re.search(key + r"=(\d+)", str(e))
                    if m:
                        kw[key] = int(m.group(1))
        padded_default_fits[nb] = kw == {"list_size": list_1m}
        print(f"  padded at n={nb}: runs with {kw} (the defaults fit: "
              f"{padded_default_fits[nb]})")
        a_pad = barneshut.barneshut_accelerations(bd.pos, bd.mass, traversal="padded", **kw)
        a_flat = (acc if nb == BH_N else
                  barneshut.barneshut_accelerations(bd.pos, bd.mass, list_size=list_1m))
        scale = a_flat.abs().max().item()
        d = (a_pad - a_flat).abs().max().item() / scale
        print(f"  padded against flat at n={nb}: max |diff| / force scale {d:.4e} "
              "(bound 2e-3, tests/test_barneshut.py:195)")
        check(d < 2e-3 and bool(torch.isfinite(a_pad).all()), "padded agrees with flat")

    # 21. the list-path main path
    print(f"[21] list-path main path: {BH_N} bodies x {BH_STEPS} KDK steps, --algo "
          "barnes-hut --bh-traversal flat, f32, --energy, --write-every 5")
    out_l = os.path.join(tmp, "list.csv")
    argv = [csv1m, *BH_WINDOW, out_l, "--energy", "--write-every", "5", "--algo",
            "barnes-hut", "--bh-traversal", "flat"]
    counters = (cuda_lists.eval_lists, cuda_lists.eval_lists_f64,
                bh_fused.fused_group_forces, bh_fused_df.fused_group_forces_df,
                cuda_rect_accelerations, cuda_rect_accelerations_f64,
                cuda_potential_energy, cuda_potential_energy_f64)

    def main_path(argv):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, text, err = run_cli_rc(argv)
        torch.cuda.synchronize()
        return rc, text, err, time.perf_counter() - t0, [c.launches for c in counters]

    rc, text, err, wall, launches = main_path(argv)
    flag = []
    if rc == 3:
        m = re.search(r"--bh-list-size (\d+)", err)
        check(m is not None, "the overflowing probe names the list size that fits")
        flag = ["--bh-list-size", m.group(1)]
        print(f"  the probe exits 3 with the default capacities; rerun with "
              f"{' '.join(flag)} (a finding)")
        rc, text, err, wall, launches = main_path([*argv, *flag])
    check(rc == 0, f"CLI exit code {rc}")
    k7_l, k7_64, k6_l, k6df_l, k1_l, k4_l, k3_l, k5_l = launches
    print(f"  launches: K7 {k7_l} (want {BH_STEPS + 2}: probe + {BH_STEPS + 1} "
          f"evaluations), potential {k3_l} (want 2), K6 {k6_l}, all-pairs {k1_l}, "
          f"fp64 kernels {k7_64 + k6df_l + k4_l + k5_l} (want 0); whole CLI call "
          f"{wall:.4f} s")
    check("Algorithm: barnes-hut, backend: cuda, dtype: f32" in text,
          "--bh-traversal flat took the list path on the kernel backend")
    check(k7_l == BH_STEPS + 2 and k3_l == 2, "K7 / K3 launches")
    check(k6_l == k6df_l == k1_l == k4_l == k7_64 == k5_l == 0, "no other kernel")
    frames_l = load_frames(out_l, BH_N, frames=2)
    drift_l = cli_number(text, "Relative energy drift:")
    t_bh = BH_STEPS * BH_DT
    pos_bound = dlist * t_bh * t_bh + 2e-6
    dpos = float(np.abs(frames_l[-1, :, 1:4] - frames_ex[-1, :, 1:4]).max())
    print(f"  final positions against the exhaustive run's ([10]) max |diff| {dpos:.3e} "
          f"(bound max|da| T^2 + 2e-6 = {pos_bound:.3e}); drift list path "
          f"{drift_l:.6e} vs exhaustive {drift_ex:.6e}, |diff| "
          f"{abs(drift_l - drift_ex):.3e} (bound 1e-3); fused ([9]) {drift_bh32:.6e}")
    check(dpos < pos_bound, "final positions agree with the exhaustive run")
    check(abs(drift_l - drift_ex) < 1e-3, "drift agrees with the exhaustive run")

    # 22. the f64 list path
    print(f"[22] f64 list path: {BH_N} bodies x {BH_STEPS} KDK steps, --dtype f64 "
          "--bh-traversal flat --energy --write-every 5")
    out_l64 = os.path.join(tmp, "list64.csv")
    rc, text, err, wall, launches = main_path(
        [csv1m, *BH_WINDOW, out_l64, "--energy", "--write-every", "5", "--algo",
         "barnes-hut", "--bh-traversal", "flat", "--dtype", "f64", *flag])
    check(rc == 0, f"CLI exit code {rc}")
    k7_32, k7_64_l, k6_l, k6df_l, k1_l, k4_l, k3_l, k5_l = launches
    print(f"  launches: K7 fp64 {k7_64_l} (want {BH_STEPS + 2}), fp64 potential {k5_l} "
          f"(want 2), K7 f32 {k7_32}, K6 {k6_l}, K6 df {k6df_l}, all-pairs {k1_l + k4_l}, "
          f"f32 potential {k3_l} (want 0); whole CLI call {wall:.4f} s")
    check("Algorithm: barnes-hut, backend: cuda, dtype: f64" in text,
          "the f64 list path took the kernel backend")
    check(k7_64_l == BH_STEPS + 2 and k5_l == 2, "K7 fp64 / K5 launches")
    check(k7_32 == k6_l == k6df_l == k1_l == k4_l == k3_l == 0, "no other kernel")
    load_frames(out_l64, BH_N, frames=2)
    drift_l64 = cli_number(text, "Relative energy drift:")
    print(f"  drift f64 {drift_l64:.6e} against the f32 list run's {drift_l:.6e}, |diff| "
          f"{abs(drift_l64 - drift_l):.3e} (bound 1e-3)")
    check(abs(drift_l64 - drift_l) < 1e-3, "f64 and f32 list-path drifts agree")
    b1m64 = bodies[BH_N, f64]
    acc64 = barneshut.barneshut_accelerations(b1m64.pos, b1m64.mass, list_size=list_1m)
    exact64 = cuda_accelerations_f64(b1m64.pos, b1m64.mass)
    torch.cuda.synchronize()
    rel64 = (acc64 - exact64).abs().max().item() / exact64.abs().max().item()
    print(f"  barneshut_accelerations f64 against K4's exact forces: max |a - exact| / "
          f"max |a| = {rel64:.4e} (bound {BH_BOUND}; f32 {rel:.4e})")
    check(rel64 < BH_BOUND and bool(torch.isfinite(acc64).all()),
          "f64 list path within 0.02 of exact forces at 1M")
    del acc64, exact64

    # 23. timing
    print(f"[23] list-path timing on {card}")
    ms = {}
    # the issue floors on real pairs: SASS instructions a pair ([1]) over the
    # fp32 (128) or fp64 (64) lanes of every SM
    floors = {f32: (sass_of(sass, "group_lists_kernelIf"), fp32_per_rsq, 128),
              f64: (sass_of(sass, "group_lists_kernelId"), fp64_per_seed, 64)}
    for (nb, dtype), (gl, _, plain_ms) in k7.items():
        wrap = wrappers[dtype]
        ms[nb, dtype] = cuda_ms(torch, lambda: wrap(gl.pg, gl.lists, gl.lengths,
                                                    eps2=0.01), 10)
        _, _, pairs, issued = lists_work(gl, 4, cuda_lists.k7_split(*gl.pg.shape[:2], sms))
        counts, per_pair, lanes = floors[dtype]
        floor = ("not measured" if counts is None else
                 f"{issue_floor_ms(per_pair(counts), pairs, lanes, sms):.4f} ms "
                 f"({per_pair(counts):.2f} instructions a pair)")
        name = "f32" if dtype == f32 else "fp64"
        before = (f" (before the redesign {BEFORE_MS[f'K7 {name} 1M']} ms, "
                  f"{ms[nb, dtype] / BEFORE_MS[f'K7 {name} 1M']:.3f}x)" if nb == BH_N else "")
        print(f"  K7 {name} at n={nb}: kernel {ms[nb, dtype]:.4f} ms{before} "
              f"({issued / ms[nb, dtype] / 1e-3:.4e} issued slot-pairs/s, "
              f"{pairs / ms[nb, dtype] / 1e-3:.4e} real pairs/s), issue floor {floor}, "
              f"plain {plain_ms:.4f} ms (one run) [{card}]")
    # both entries at every number of list slices a block, each held against
    # the plain version (f32: K1's bound; fp64: F64_BOUND of the force
    # scale), with bit-identical reruns
    for (nb, dtype), (gl, _, _) in k7.items():
        want, wrap = k7_want[nb, dtype], wrappers[dtype]
        g_, b_, _ = gl.pg.shape
        scale = want.abs().max().item()
        split_ms, rels = {}, {}
        for split in (1, 2, 4, 8):
            got = wrap(gl.pg, gl.lists, gl.lengths, eps2=0.01, _split=split)
            err = (got - want).abs()
            rels[split] = err.max().item() / scale
            ok = (bool((err <= ATOL_REL * scale + RTOL * want.abs()).all())
                  if dtype == f32 else rels[split] <= F64_BOUND)
            check(ok and bool(torch.isfinite(got).all()) and torch.equal(
                wrap(gl.pg, gl.lists, gl.lengths, eps2=0.01, _split=split), got),
                f"K7 {dtype} at {split} list slices against its plain version, reruns")
            split_ms[split] = cuda_ms(torch, lambda: wrap(
                gl.pg, gl.lists, gl.lengths, eps2=0.01, _split=split), 5)
        bound_s = (f"{ATOL_REL:g}*scale + {RTOL:g}*|want|" if dtype == f32
                   else f"{F64_BOUND:g}")
        print(f"  K7 {'f32' if dtype == f32 else 'fp64'} at n={nb} ({g_} group slots, B "
              f"{b_}; the pick {cuda_lists.k7_split(g_, b_, sms)} list slices): 1/2/4/8 "
              "slices " + " / ".join(f"{split_ms[k]:.4f}" for k in (1, 2, 4, 8))
              + " ms, max |err| / scale " + " / ".join(f"{rels[k]:.2e}" for k in (1, 2, 4, 8))
              + f" (bound {bound_s}), reruns bit-identical [{card}]")
    del k7_want, want, got
    kw = dict(list_size=list_1m)
    gs, sl, lc, depth = barneshut.list_layout(BH_N, 9, 0, 0)
    prep = barneshut._prepare(b1m.pos, b1m.mass, depth, gs, sl)
    _, perm, levels, border, pos_s, mass_s, gidx, gval, pg, lo, hi = prep
    gm_s = mass_s * 1.0
    trav = dict(G=1.0, theta=0.5, leaf_cap=lc, frontier_size=1024, range_size=1024,
                list_size=list_1m, traversal="flat")
    lists, lengths, _ = barneshut.traverse_groups(levels, border, pos_s, gm_s, lo, hi,
                                                  **trav)
    acc_g = cuda_lists.eval_lists(pg, lists, lengths, eps2=0.01)
    prep_ms = cuda_ms(torch, lambda: barneshut._prepare(b1m.pos, b1m.mass, depth, gs, sl),
                      10)
    trav_ms = cuda_ms(torch, lambda: barneshut.traverse_groups(
        levels, border, pos_s, gm_s, lo, hi, **trav), 10)
    scat_ms = cuda_ms(torch, lambda: barneshut.scatter_groups(acc_g, gidx, gval, perm), 10)
    whole_ms = cuda_ms(torch, lambda: barneshut.barneshut_accelerations(
        b1m.pos, b1m.mass, **kw), 10)
    k7_1m = ms[BH_N, f32]
    print(f"  barneshut_accelerations (flat) at {BH_N}: whole {whole_ms:.4f} ms = "
          f"sort+tree+groups {prep_ms:.4f} ms + traversal {trav_ms:.4f} ms + K7 "
          f"{k7_1m:.4f} ms + scatter {scat_ms:.4f} ms (parts timed apart); traversal "
          f"share {trav_ms / (prep_ms + trav_ms + k7_1m + scat_ms):.3f} [{card}]")
    del prep, levels, lists, acc_g
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    barneshut.barneshut_accelerations(b1m.pos, b1m.mass, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        barneshut.barneshut_accelerations(b1m.pos, b1m.mass, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the kernels' own rows: an operator's row repeats its kernels' time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:3]
    print(f"  profile of one list-path evaluation at {BH_N}: wall {wall_ms:.4f} ms "
          f"(profiled), kernels {device_ms:.4f} ms on the device, busy share "
          f"{device_ms / wall_ms:.3f}, {launches} kernel launches; top: "
          + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.4f} ms"
                      for e in top) + f" [{card}]")
    turns = ["flat", "fused", "fused", "flat"]
    if padded_default_fits[BH_N]:  # the CLI has no flag for the padded sizes
        turns.append("padded")
    for trav_name in turns:
        rc, text, _ = run_cli_rc([csv1m, *BH_WINDOW, os.path.join(tmp, "x.csv"),
                                  "--no-output", "--algo", "barnes-hut",
                                  "--bh-traversal", trav_name,
                                  *(flag if trav_name != "fused" else [])])
        check(rc == 0, f"--bh-traversal {trav_name} --no-output exit code {rc}")
        sim = cli_number(text, "Elapsed wall time:")
        print(f"  {BH_N} --no-output --bh-traversal {trav_name}: simulate {sim:.4f} s "
              f"-> {sim / BH_STEPS:.4f} s/step [{card}]")
    for _ in range(2):  # the f64 list path: K7's fp64 entry
        rc, text, _ = run_cli_rc([csv1m, *BH_WINDOW, os.path.join(tmp, "x.csv"),
                                  "--no-output", "--algo", "barnes-hut",
                                  "--bh-traversal", "flat", "--dtype", "f64", *flag])
        check(rc == 0, f"--bh-traversal flat --dtype f64 --no-output exit code {rc}")
        sim = cli_number(text, "Elapsed wall time:")
        print(f"  {BH_N} --no-output --bh-traversal flat --dtype f64: simulate "
              f"{sim:.4f} s -> {sim / BH_STEPS:.4f} s/step [{card}]")

    entries = []
    for dtype, name, launches_main in ((f32, "group_lists_f32", k7_l),
                                       (f64, "group_lists_f64", k7_64_l)):
        gl, err, plain_ms = k7[BH_N, dtype]
        real = 4 if dtype == f32 else 8
        nbytes, ops, _, _ = lists_work(gl, real, 1)
        bd = bound(nbytes, ops, FP32_PEAK if dtype == f32 else FP64_PEAK)
        entries.append(
            {"name": name, "route": "cuda", "source": "nbody_tpu_torch/csrc/group_lists.cu",
             "replaces": "nbody_tpu/ops/barneshut.py:52", "launches": launches_main,
             "max_abs_err": err, "ms": ms[BH_N, dtype], "plain_ms": plain_ms,
             "bound_ms": bd[0], "bound_by": bd[1], "library_ms": None})
        print(f"  K7 {name} at {BH_N}: bound {bd[0]:.4f} ms ({bd[1]}), "
              f"{ms[BH_N, dtype] / bd[0]:.2f}x the bound")
    return entries


def fp64_forces(targets, pos, mass, G: float = 1.0, eps2: float = 0.01) -> np.ndarray:
    """The reference's fp64 force formula in numpy (serial/exhaustive.c:
    155-181, tests/oracle.py): a of `targets` from all (pos, mass)."""
    d = pos[None, :, :] - targets[:, None, :]
    r2 = (d * d).sum(-1) + eps2
    return ((G * mass[None, :] * r2 ** -1.5)[..., None] * d).sum(1)


def fp64_phases(torch, dev, card: str, sass: dict, arr, arr1m, csv1m: str, tmp: str,
                drift_bh32: float, pe64_1m: tuple[float, float]) -> list[dict]:
    """Phases [12]-[18]: the fp64 kernels and the --dtype f64 paths;
    `pe64_1m` is [6]'s plain fp64 PE of the 1M cloud and its ms.  Returns
    the fp64 kernels' entries of the JSON line."""
    from nbody_tpu_torch.cli.main import build_force_fn
    from nbody_tpu_torch.core.types import Bodies, SimConfig
    from nbody_tpu_torch.diag.energy import energy_drift, get_energy
    from nbody_tpu_torch.integrate.leapfrog import simulate
    from nbody_tpu_torch.diag import fused_stages as fs
    from nbody_tpu_torch.ops import _cuda, bh_fused, bh_fused_df
    from nbody_tpu_torch.ops.cuda_exhaustive import (
        cuda_potential_energy,
        cuda_rect_accelerations,
        potential_energy_reference,
    )
    from nbody_tpu_torch.ops.cuda_fp64 import (
        cuda_accelerations_f64,
        cuda_potential_energy_f64,
        cuda_rect_accelerations_f64,
        k4_split,
    )
    from nbody_tpu_torch.ops.cuda_exhaustive import rect_accelerations_reference
    from nbody_tpu_torch.utils.fixtures import random_cloud

    f64 = torch.float64
    n = arr.shape[0]
    b64 = Bodies.from_numpy(arr, dtype=f64, device=dev)

    # 12. fp64 all-pairs kernel
    print("[12] fp64 all-pairs kernel K4 (nbody_tpu_torch/csrc/allpairs_f64.cu)")
    got = cuda_accelerations_f64(b64.pos, b64.mass)
    want = rect_accelerations_reference(b64.pos, b64.pos, b64.mass)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    k4_err = (got - want).abs().max().item()
    print(f"  {n} x {n} against the plain version: max |err| {k4_err:.3e}, force "
          f"scale {scale:.4e}, rel {k4_err / scale:.3e} (bound {F64_BOUND:g})")
    check(k4_err <= F64_BOUND * scale and bool(torch.isfinite(got).all()),
          "K4 against its plain version")
    rows = np.sort(np.random.default_rng(0).choice(n, 256, replace=False))
    oracle = np.concatenate([fp64_forces(arr[rows[k:k + 32], :3], arr[:, :3], arr[:, 6])
                             for k in range(0, len(rows), 32)])
    got_rows = got[torch.as_tensor(rows, device=dev)].cpu().numpy()
    rel = float(np.abs(got_rows - oracle).max() / np.abs(oracle).max())
    print(f"  256 targets x {n} against the fp64 formula (numpy, r2**-1.5): rel "
          f"{rel:.3e} (bound {F64_BOUND:g})")
    check(rel < F64_BOUND, "K4 against the fp64 formula")
    check(torch.equal(cuda_accelerations_f64(b64.pos, b64.mass), got),
          "K4 reruns are bit-identical")
    sms = _cuda.sm_count(dev)
    print(f"  two kernel runs bit-identical: True; source slices a block {k4_split(n, sms)} "
          f"({sms} SMs)")
    # a ragged rectangle, and the robust path's 1M x 1,953 outlier rectangle,
    # where M fills the card and the split is 1
    c = torch.as_tensor(random_cloud(BH_N, seed=0), device=dev)
    rects = {}
    for m_, n_ in ((100_003, 4_099), (BH_N, 1_953)):
        pi, pj, mj = c[:m_, :3].contiguous(), c[:n_, :3].contiguous(), c[:n_, 6].contiguous()
        got_r = cuda_rect_accelerations_f64(pi, pj, mj)
        want_r = rect_accelerations_reference(pi, pj, mj)
        torch.cuda.synchronize()
        rel = (got_r - want_r).abs().max().item() / want_r.abs().max().item()
        print(f"  {m_} x {n_} (source slices {k4_split(m_, sms)}) against the plain version: "
              f"rel {rel:.3e} (bound {F64_BOUND:g}); reruns bit-identical")
        check(rel <= F64_BOUND and torch.equal(cuda_rect_accelerations_f64(pi, pj, mj), got_r),
              f"K4 {m_} x {n_} against its plain version, bit-identical reruns")
        rects[m_, n_] = (pi, pj, mj)
    del c, got_r, want_r

    # 13. fp64 potential-energy kernel
    print("[13] fp64 potential-energy kernel K5 (nbody_tpu_torch/csrc/potential_f64.cu)")
    pe = cuda_potential_energy_f64(b64.pos, b64.mass).item()
    pe_plain = potential_energy_reference(b64.pos, b64.mass).item()
    k5_err = abs(pe - pe_plain)
    print(f"  n={n}: kernel {pe!r}, plain {pe_plain!r}, rel {k5_err / abs(pe_plain):.3e} "
          f"(bound {F64_PE_BOUND:g})")
    check(k5_err <= F64_PE_BOUND * abs(pe_plain), "K5 against its plain version")
    check(cuda_potential_energy_f64(b64.pos, b64.mass).item() == pe,
          "K5 reruns are bit-identical")
    print("  two kernel runs bit-identical: True")
    c = torch.as_tensor(random_cloud(5_003, seed=5), dtype=f64, device=dev)
    pe_check(cuda_potential_energy_f64, {"plain version": potential_energy_reference},
             c[:, :3].contiguous(), c[:, 6].contiguous(), F64_PE_BOUND, "K5")

    # 14. K6's df mode against its plain version, at 100k, 1M and on the
    # robust input; its base pieces heaviest first and in slot order
    print("[14] K6 df mode (nbody_tpu_torch/csrc/bh_fused.cu, nbody_bh_fused_f64)")
    b1m64 = Bodies.from_numpy(arr1m, dtype=f64, device=dev)
    df = {}  # label -> (kernel arguments, keywords, max |err|, stats, plain ms)
    inputs = (("100k", lambda: fs.k6_args(bh_fused.prepare_fused(b64.pos, b64.mass))),
              ("1M uniform", lambda: fs.k6_args(bh_fused.prepare_fused(b1m64.pos,
                                                                       b1m64.mass))),
              ("robust ld 8", lambda: fs.robust_inputs(BH_N, dev, ld=8, dtype=f64)))
    for label, make in inputs:
        args, kw = make()
        gcount = args[2]
        got_s, stats_k = bh_fused_df.fused_group_forces_df(*args, **kw)
        (want_s, stats_p), plain_ms = timed_once(
            torch, lambda: bh_fused_df.fused_group_forces_df_reference(*args, **kw))
        scale = want_s.abs().max().item()
        err = (got_s - want_s).abs().max().item()
        del want_s
        print(f"  {label}, ld {kw['ld']}, {gcount.shape[0]} group slots, B "
              f"{kw['group_size']}: max |err| {err:.3e}, force scale {scale:.4e}, rel "
              f"{err / scale:.3e} (bound {F64_BOUND:g}); plain {plain_ms:.1f} ms (one run)")
        check(err <= F64_BOUND * scale and bool(torch.isfinite(got_s).all()),
              "K6 df against its plain version")
        lanes = {name: int(stats_k[:, lane].long().sum())
                 for name, lane in (("pops", bh_fused.S_POPS),
                                    ("near_bodies", bh_fused.S_NEAR),
                                    ("far_children", bh_fused.S_FAR))}
        lanes["frontier_overflow"] = int(stats_k[:, bh_fused.S_OVF].max())
        print(f"  stats {lanes}; equal to the plain version's lane by lane: "
              f"{bool(torch.equal(stats_k, stats_p))}")
        check(torch.equal(stats_k, stats_p), "K6 df stats equal the plain version's")
        check(lanes["far_children"] > 0 and lanes["frontier_overflow"] == 0,
              "K6 df accepted far cells without overflow")
        again_s, again_stats = bh_fused_df.fused_group_forces_df(*args, **kw)
        check(torch.equal(again_s, got_s) and torch.equal(again_stats, stats_k),
              "K6 df reruns are bit-identical")
        est, pieces = bh_fused.df_launch_pieces(*args, **kw)
        check(torch.equal(est, stats_k), "the pricing pass's stats are full's")
        heavy, st_heavy = bh_fused.kernel_forces(f64, *args, **kw, pieces=pieces)
        slot, st_slot = bh_fused.kernel_forces(f64, *args, **kw)  # base pieces, slot order
        check(torch.equal(heavy, got_s) and torch.equal(st_heavy, stats_k)
              and torch.equal(slot, got_s) and torch.equal(st_slot, stats_k),
              f"{label}: the pieces heaviest first and in slot order give the wrapper's bits")
        used = pieces[pieces[:, 2] > pieces[:, 1]]
        n_pieces, most = used.shape[0], int(torch.bincount(used[:, 0].long()).max())
        check(most > 1, f"{label}: a group runs as several pieces")
        print(f"  two kernel runs bit-identical; the base pieces ({n_pieces}, up to {most} "
              f"a group) heaviest first and in slot order bit-identical: True")
        df[label] = (args, kw, err, stats_k, plain_ms)
        del got_s, again_s, slot, heavy

    # 15. the f64 all-pairs main path
    print(f"[15] f64 main path: {n} bodies x {STEPS} KDK steps, --dtype f64 --energy")
    out = os.path.join(tmp, "cuda64.csv")
    counters = (cuda_rect_accelerations, cuda_rect_accelerations_f64,
                cuda_potential_energy, cuda_potential_energy_f64)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = run_cli([CSV_100K, *MAIN_WINDOW, out, "--energy", "--dtype", "f64"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k4_launches, k3, k5_launches = (c.launches for c in counters)
    print(f"  launches: fp64 all-pairs {k4_launches} (want {STEPS + 1}), fp64 "
          f"potential {k5_launches} (want 2), f32 all-pairs {k1} and potential {k3} "
          f"(want 0); whole CLI call {wall:.4f} s")
    check(k4_launches == STEPS + 1 and k5_launches == 2, "K4 / K5 launches")
    check(k1 == 0 and k3 == 0, "no f32 kernel on the f64 path")
    check("backend: cuda, dtype: f64" in text, "the f64 main path took the kernels")
    frames = load_frames(out, n)
    drift_k = cli_number(text, "Relative energy drift:")
    # the same steps in-process, through the kernel and the plain backend's
    # force, so the final positions compare at full precision
    dt = SimConfig.c_float(float(MAIN_WINDOW[2]))
    fin = {label: simulate(b64, STEPS, dt, build_force_fn(label, 1.0, 0.01, dtype="f64"))
           for label in ("cuda", "torch")}
    torch.cuda.synchronize()
    dpos = (fin["cuda"].pos - fin["torch"].pos).abs().max().item()
    dframe = float(np.abs(frames[-1, :, 1:4] - fin["cuda"].pos.cpu().numpy()).max())
    e0 = sum(get_energy(b64.pos, b64.vel, b64.mass))
    e1 = sum(get_energy(fin["torch"].pos, fin["torch"].vel, fin["torch"].mass))
    drift_t = energy_drift(e1, e0)
    print(f"  in-process, kernel against plain backend: final positions max |diff| "
          f"{dpos:.3e} (bound {F64_POS_BOUND:g}); the CLI's last frame against the "
          f"kernel's {dframe:.3e} (%lf resolution, bound 1e-6)")
    print(f"  drift: CLI (K4, K5) {drift_k:.6e}, plain backend {drift_t:.6e}, |diff| "
          f"{abs(drift_k - drift_t):.3e} (bound 1e-3)")
    check(dpos < F64_POS_BOUND, "f64 final positions agree")
    check(dframe < 1e-6, "the CLI's frames are the kernel's run")
    check(abs(drift_k - drift_t) < 1e-3, "f64 energy drifts agree")

    # 16. the f64 Barnes-Hut main path
    print(f"[16] f64 Barnes-Hut main path: {BH_N} bodies x {BH_STEPS} KDK steps, "
          "--algo auto --dtype f64 --energy --write-every 5")
    out_bh = os.path.join(tmp, "bh64.csv")
    counters = (bh_fused.fused_group_forces, bh_fused_df.fused_group_forces_df,
                cuda_rect_accelerations_f64, cuda_potential_energy_f64,
                cuda_potential_energy)
    for c in counters:
        c.launches = 0
    bh_fused_df.fused_group_forces_df.evaluations = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text_bh = run_cli([csv1m, *BH_WINDOW, out_bh, "--energy", "--write-every", "5",
                       "--dtype", "f64", "--algo", "auto"])
    torch.cuda.synchronize()
    wall_bh = time.perf_counter() - t0
    k6, k6df_launches, k4_bh, k5_bh, k3_bh = (c.launches for c in counters)
    k6df_evals = bh_fused_df.fused_group_forces_df.evaluations
    print(f"  launches: K6 df {k6df_launches} in {k6df_evals} evaluations (want "
          f"{BH_STEPS + 1}, two launches each: the pricing pass and the full kernel, and "
          f"the probe's pricing launch), fp64 potential {k5_bh} (want 2), K6 f32 "
          f"{k6}, fp64 all-pairs {k4_bh}, f32 potential {k3_bh} (want 0); whole CLI call "
          f"{wall_bh:.4f} s")
    check("Algorithm: barnes-hut, backend: cuda/fused, dtype: f64" in text_bh,
          "--algo auto --dtype f64 took K6's df mode")
    check(k6df_evals == BH_STEPS + 1 and k6df_launches == 2 * k6df_evals + 1 and k5_bh == 2,
          "K6 df / K5 launches")
    check(k6 == 0 and k4_bh == 0 and k3_bh == 0, "no other kernel on the path")
    load_frames(out_bh, BH_N, frames=2)
    drift_bh64 = cli_number(text_bh, "Relative energy drift:")
    print(f"  drift f64 {drift_bh64:.6e} against the f32 run's {drift_bh32:.6e} ([9]), "
          f"|diff| {abs(drift_bh64 - drift_bh32):.3e} (bound 1e-3)")
    check(abs(drift_bh64 - drift_bh32) < 1e-3, "f64 and f32 Barnes-Hut drifts agree")
    acc = bh_fused_df.barneshut_fused_df(b1m64.pos, b1m64.mass)
    exact = cuda_accelerations_f64(b1m64.pos, b1m64.mass)
    torch.cuda.synchronize()
    dmax = (acc - exact).abs().max().item()
    rel = dmax / exact.abs().max().item()
    print(f"  barneshut_fused_df against K4's exact forces: max |a - exact| / max |a| "
          f"= {rel:.4e} (bound {BH_BOUND})")
    check(rel < BH_BOUND and bool(torch.isfinite(acc).all()),
          "f64 Barnes-Hut within 0.02 of exact forces at 1M")
    for dtype in ("f32", "f64", "f64", "f32"):
        text = run_cli([csv1m, *BH_WINDOW, os.path.join(tmp, "x.csv"), "--no-output",
                        "--algo", "auto", "--dtype", dtype])
        sim = cli_number(text, "Elapsed wall time:")
        print(f"  {BH_N} --no-output --algo auto --dtype {dtype}: simulate {sim:.4f} s "
              f"-> {sim / BH_STEPS:.4f} s/step [{card}]")

    # 17. the fp64 sun-earth run through K4
    print("[17] sun-earth, fp64, 8640 steps of 1000 s, --G 6.67e-11 --energy (K4)")
    cuda_rect_accelerations_f64.launches = 0
    text = run_cli([SUN_EARTH, "0", "8640000", "1000", os.path.join(tmp, "se.csv"),
                    "--dtype", "f64", "--G", "6.67e-11", "--energy", "--no-output"])
    drift_se = cli_number(text, "Relative energy drift:")
    se_launches = cuda_rect_accelerations_f64.launches
    print(f"  K4 launches {se_launches} (want 8641); drift {drift_se:.3e} (bound 1e-10)")
    check(se_launches == 8641 and "backend: cuda, dtype: f64" in text,
          "the sun-earth run took K4")
    check(drift_se < 1e-10, "sun-earth fp64 drift")

    # 18. fp64 timing
    print(f"[18] fp64 timing on {card}")
    k4_ms = cuda_ms(torch, lambda: cuda_accelerations_f64(b64.pos, b64.mass), 10)
    clocks = "; ".join(clock_and_power(torch, lambda: cuda_accelerations_f64(b64.pos,
                                                                         b64.mass)))
    k4_plain_ms = cuda_ms(torch, lambda: rect_accelerations_reference(b64.pos, b64.pos,
                                                                     b64.mass), 2)
    k4_rect_ms = {mn: cuda_ms(torch, lambda: cuda_rect_accelerations_f64(*r), 10)
                  for mn, r in rects.items()}
    k5_ms = cuda_ms(torch, lambda: cuda_potential_energy_f64(b64.pos, b64.mass), 10)
    k5_plain_ms = cuda_ms(torch, lambda: potential_energy_reference(b64.pos, b64.mass), 2)
    k5_1m = cuda_potential_energy_f64(b1m64.pos, b1m64.mass).item()
    k5_1m_ms = cuda_ms(torch, lambda: cuda_potential_energy_f64(b1m64.pos, b1m64.mass), 3)
    k6df_ms = {label: cuda_ms(torch, lambda: bh_fused_df.fused_group_forces_df(*a_, **kw_),
                              3 if label.startswith("robust") else 10)
               for label, (a_, kw_, _, _, _) in df.items()}
    slot_ms = {label: cuda_ms(torch, lambda: bh_fused.kernel_forces(f64, *a_, **kw_),
                              3 if label.startswith("robust") else 10)
               for label, (a_, kw_, _, _, _) in df.items()}
    whole_ms = cuda_ms(torch, lambda: bh_fused_df.barneshut_fused_df(b1m64.pos, b1m64.mass),
                       10)
    pairs = float(n) ** 2
    real = 8
    print(f"  K4 {n}x{n}: kernel {k4_ms:.4f} ms ({pairs / k4_ms / 1e-3:.4e} pairs/s; before "
          f"the redesign {BEFORE_MS['K4 100k']} ms), plain {k4_plain_ms:.4f} ms; SM clock and power draw "
          f"while it runs: {clocks} [{card}]")
    for (m_, n_), ms in k4_rect_ms.items():
        kb = bound((m_ * 3 + n_ * 4 + m_ * 3) * real, float(m_) * n_ * FORCE_OPS, FP64_PEAK)
        print(f"  K4 {m_}x{n_}: kernel {ms:.4f} ms (before {BEFORE_MS[f'K4 {m_}x{n_}']} ms), "
              f"bound {kb[0]:.4f} ms ({kb[1]}) [{card}]")
    rel = abs(k5_1m - pe64_1m[0]) / abs(pe64_1m[0])
    print(f"  K5 {BH_N}: kernel {k5_1m!r}, plain {pe64_1m[0]!r} ([6]), rel {rel:.3e} "
          f"(bound {F64_PE_BOUND:g})")
    check(rel <= F64_PE_BOUND, f"K5 at {BH_N} against its plain version")
    # K5 beside its time before the redesign, its bound on the unordered
    # pairs, its fp64 issue floor (SASS fp64 instructions a MUFU.RSQ64H, [1])
    # and its plain version's time
    k5_sass = sass_of(sass, "PeF64")
    for nn, ms, plain in ((n, k5_ms, f"{k5_plain_ms:.4f} ms"),
                          (BH_N, k5_1m_ms, f"{pe64_1m[1]:.1f} ms (one run, [6])")):
        floor = ("fp64 issue floor not measured" if k5_sass is None else
                 f"fp64 issue floor {issue_floor_ms(fp64_per_seed(k5_sass), nn * (nn - 1) / 2, 64, sms):.4f}"
                 f" ms ({fp64_per_seed(k5_sass):.2f} fp64 instructions a pair, {sms} SMs at "
                 f"{CLOCK_HZ / 1e6:.0f} MHz)")
        pe_report("K5", nn, ms, plain, floor, 8, FP64_PEAK, card)
    for label, (a_, kw_, _, st_, plain_) in df.items():
        kb = bound(*fused_work(a_, st_, real), FP64_PEAK)
        before = BEFORE_MS["K6 df " + label]
        print(f"  K6 df {label} (ld {kw_['ld']}): the wrapper (pricing pass + pieces "
              f"heaviest first) {k6df_ms[label]:.4f} ms (before {before} ms, "
              f"{k6df_ms[label] / before:.3f}x); the full kernel over the base pieces in "
              f"slot order, unpriced, {slot_ms[label]:.4f} ms (the wrapper "
              f"{k6df_ms[label] / slot_ms[label]:.3f}x it); bound {kb[0]:.4f} ms "
              f"({kb[1]}), plain {plain_:.1f} ms (one run) [{card}]")
    k4_shapes = {(n, n): (b64.pos, b64.pos, b64.mass), (BH_N, 1_953): rects[BH_N, 1_953]}
    for split in (1, 2, 4, 8):
        ms = {mn: cuda_ms(torch, lambda: cuda_rect_accelerations_f64(*r, _split=split), 5)
              for mn, r in k4_shapes.items()}
        print(f"  K4 with {split} source slices a block: {n}x{n} {ms[n, n]:.4f} ms, "
              f"{BH_N}x1953 {ms[BH_N, 1_953]:.4f} ms [{card}]")
    print(f"  barneshut_fused_df at {BH_N}: whole {whole_ms:.4f} ms [{card}]")
    for _ in range(2):
        text = run_cli([CSV_100K, *MAIN_WINDOW, os.path.join(tmp, "x.csv"), "--no-output",
                        "--dtype", "f64"])
        sim = cli_number(text, "Elapsed wall time:")
        print(f"  {n} --no-output --dtype f64 (K4): simulate {sim:.4f} s -> "
              f"{sim / STEPS:.4f} s/step, {(STEPS + 1) * pairs / sim:.4e} pairs/s [{card}]")

    small = (2 * n * 3 + n + n * 3) * real  # pos_i, pos_j, mass, out
    k4_bound = bound(small, pairs * FORCE_OPS, FP64_PEAK)
    k5_bound = pe_bound(n, real, FP64_PEAK)
    entries = [
        {"name": "allpairs_f64", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/allpairs_f64.cu",
         "replaces": "nbody_tpu/ops/pallas_df.py:172",
         "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
         "library_ms": None},
        {"name": "potential_f64", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/potential_f64.cu",
         "replaces": "nbody_tpu/ops/pallas_df.py:217",
         "launches": k5_launches, "max_abs_err": k5_err, "ms": k5_ms,
         "plain_ms": k5_plain_ms, "bound_ms": k5_bound[0], "bound_by": k5_bound[1],
         "library_ms": None},
    ]
    # K6 df on the 1M uniform cloud (the --algo auto --dtype f64 main path,
    # [16]) and on the robust input (the robust f64 main path, [27], which
    # fills in its launches)
    for name, label, launches, evals in (("bh_fused_df", "1M uniform", k6df_launches,
                                          k6df_evals),
                                         ("bh_fused_df_robust", "robust ld 8", None, None)):
        a_, _, err_, st_, plain_ = df[label]
        kb = bound(*fused_work(a_, st_, real), FP64_PEAK)
        entries.append({"name": name, "route": "cuda",
                        "source": "nbody_tpu_torch/csrc/bh_fused.cu",
                        "replaces": "nbody_tpu/ops/bh_fused.py:130",
                        "launches": launches, "evaluations": evals, "max_abs_err": err_,
                        "ms": k6df_ms[label], "plain_ms": plain_, "bound_ms": kb[0],
                        "bound_by": kb[1], "library_ms": None})
    return entries


# CUDA-core operations per pair of K2: 3 sub, 6 for r^2 + eps, the rsqrt and
# 2 multiplies for r^-3; the j-sum and gm ride B = diag(gm) [x - c, 1] on
# the tensor cores
K2_OPS = 12
K2_TC_FLOPS = 8  # tensor-core flops per pair of the contraction W @ [x y z 1]
TF32_PEAK = 495e12  # dense TF32 tensor-core FLOP/s
OFFSET = (8.0, -8.0, 8.0)  # [24]'s cloud off the origin


def fit_unit_costs(points) -> tuple[float, float]:
    """(ns per staged source, ns per 128 classified cells) from (K6 ms,
    staged sources, classified cells, the pops cut's ms less the none
    cut's) over several inputs and depths: the classification cost from
    the stage cuts, their increment against the cells classified; then the
    source cost from K6's time less that; both by least squares through 0."""
    cells = np.array([c / 128.0 for _, _, c, _ in points])
    inc = np.array([d * 1e6 for _, _, _, d in points])
    ns_pop = float(cells @ inc / (cells @ cells))
    staged = np.array([s for _, s, _, _ in points])
    rest = np.array([ms * 1e6 for ms, _, _, _ in points]) - ns_pop * cells
    return float(staged @ rest / (staged @ staged)), ns_pop


def k6_instantiations(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill bytes) of each K6 instantiation in the
    ptxas report `log`: the mode and the stage cut."""
    from nbody_tpu_torch.ops.bh_fused import CUTS

    lines = log.splitlines()
    name_re = re.compile(r"entry function '\S*?bh_fused_(warp|df)_kernelILi(\d)E")
    out = []
    for i, line in enumerate(lines):
        m = name_re.search(line)
        if not m:
            continue
        near = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", near)
        spill = re.search(r"(\d+) bytes spill stores", near)
        kind = "f32" if m.group(1) == "warp" else "df"
        out.append((f"{kind} {CUTS[int(m.group(2))]}",
                    int(regs.group(1)) if regs else -1, int(spill.group(1)) if spill else -1))
    return out


def stage_phase(torch, dev, card: str, b100k, k1_rate: float) -> dict:
    """Phase [29]: K6's stage cuts on the card, on the 100k main-path
    bodies, the 1M uniform cloud and the robust input (ld as the pricer
    picks it, and ld 8 where it picks another).  Returns K6's entry of the
    JSON line, on the robust input."""
    from nbody_tpu_torch.diag import fused_stages as fs
    from nbody_tpu_torch.ops import _cuda, bh_fused, bh_fused_df

    f32 = torch.float32
    print(f"[29] K6 stage cuts and redesign (nbody_tpu_torch/csrc/bh_fused.cu) [{card}]")
    for kernel, regs, spill in k6_instantiations(_cuda.library().build_log):
        print(f"  {kernel}: {regs} registers, {spill} bytes spilled")
        if kernel.startswith("f32"):
            check(0 <= regs <= 64 and spill == 0, f"{kernel}: at most 64 registers, no spills")
    print("  K6 launches per f32 evaluation: 2 (the pops cut that prices the groups, then "
          "the full kernel heaviest group first)")
    inputs = [("100k", fs.k6_args(bh_fused.prepare_fused(b100k.pos, b100k.mass))),
              ("1M uniform", fs.uniform_inputs(BH_N, dev))]
    robust = fs.robust_inputs(BH_N, dev)
    inputs.append((f"robust ld {robust[1]['ld']}", robust))
    if robust[1]["ld"] != 8:
        inputs.append(("robust ld 8", fs.robust_inputs(BH_N, dev, ld=8)))
    entry = None
    for label, (args, kw) in inputs:
        prod, st = bh_fused.fused_group_forces(*args, **kw)
        slot, st_slot = bh_fused.kernel_forces(f32, *args, **kw)
        check(torch.equal(prod, slot) and torch.equal(st, st_slot),
              f"{label}: heavy-first order gives slot order's bits")
        for cut in bh_fused.CUTS:
            got, s_ = bh_fused.kernel_forces(f32, *args, **kw, debug_mode=cut,
                                             cut_entry=True)
            ok = not bool(s_.any()) if cut == "none" else bool(torch.equal(s_, st))
            check(ok, f"{label} {cut}: stats equal full's (zero in none)")
            check(cut == "full" or not bool(got.any()), f"{label} {cut}: "
                  "zero forces short of full")
        check(torch.equal(got, prod), f"{label}: the full cut is bit-identical to "
              "the production entry point")
        real, warp_issued, block_issued = fs.pair_counts(st, args[2], kw["group_size"])
        print(f"  {label} (ld {kw['ld']}, {args[1].shape[0]} group slots): all 7 cuts "
              "ran; stats equal full's lane by lane (zero in none), forces zero "
              "short of full; full cut == production entry, heavy-first == slot order: "
              f"True; real pairs {real:.4e}, issued pairs {block_issued:.4e} (whole "
              f"blocks) / {warp_issued:.4e} (live warps), source-weighted lane fill "
              f"{real / block_issued:.4f} / {real / warp_issued:.4f}")
        if label == "100k":
            continue
        order = bh_fused.heavy_first(st, args[2])
        times = fs.profile(args, kw, fs.MODES, order)
        print(fs.report(times, f"  {label} heavy-first order [{card}]"))
        t = fs.profile(args, kw, fs.SPLIT_MODES, order)
        print(fs.report(t, f"  {label} split stage, heavy-first order [{card}]"))
        slot_ms = fs.best_ms(lambda: bh_fused.kernel_forces(f32, *args, **kw))
        pricing_ms = fs.best_ms(lambda: bh_fused.kernel_forces(f32, *args, **kw,
                                                               debug_mode="pops"))
        wrapper_ms = fs.best_ms(lambda: bh_fused.fused_group_forces(*args, **kw))
        nbytes, ops = fused_work(args, st, 4)
        kb = bound(nbytes, ops, FP32_PEAK)
        print(f"  {label}: full in slot order {slot_ms:.4f} ms; the pricing pass (pops, "
              f"slot order) {pricing_ms:.4f} ms; the wrapper (pricing pass + ordered "
              f"kernel) {wrapper_ms:.4f} ms; bound {kb[0]:.4f} ms "
              f"({kb[1]}: {real:.4e} real pairs x {FORCE_OPS} operations at 67 TFLOP/s); "
              f"the pairs at K1's rate in this call ({k1_rate:.4e} pairs/s) "
              f"{real / k1_rate * 1e3:.4f} ms [{card}]")
        if label.startswith("robust") and entry is None:
            (want, _), plain_ms = timed_once(
                torch, lambda: bh_fused.fused_group_forces_reference(*args, **kw))
            err = f32_close(torch, prod, want, f"{label} against the plain version")
            entry = {"name": "bh_fused_f32", "route": "cuda",
                     "source": "nbody_tpu_torch/csrc/bh_fused.cu",
                     "replaces": "nbody_tpu/ops/bh_fused.py:130",
                     "max_abs_err": err, "ms": wrapper_ms, "plain_ms": plain_ms,
                     "bound_ms": kb[0], "bound_by": kb[1], "library_ms": None}
            print(f"  K6 on the robust input: {wrapper_ms:.4f} ms (target 40 ms; the "
                  "kernel before the redesign: 56.03 ms, PERF.md); plain "
                  f"{plain_ms:.4f} ms (one run); within 40 ms: {wrapper_ms <= 40.0} [{card}]")
        if label == "1M uniform":
            print(f"  K6 on the uniform cloud: {wrapper_ms:.4f} ms (target 7.56 ms; the "
                  "kernel before the redesign: 7.34 ms, PERF.md); within 7.56 ms: "
                  f"{wrapper_ms <= 7.56} [{card}]")
    # the df mode's cuts, taking the pieces as the wrapper does
    f64 = torch.float64
    for label, make in (
            ("random_cloud(100000)", lambda: fs.uniform_inputs(100_000, dev, dtype=f64)),
            ("1M uniform", lambda: fs.uniform_inputs(BH_N, dev, dtype=f64)),
            ("robust ld 8", lambda: fs.robust_inputs(BH_N, dev, ld=8, dtype=f64))):
        args, kw = make()
        full, st = bh_fused_df.fused_group_forces_df(*args, **kw)
        _, _, pieces = fs.production_launch(args, kw)
        for cut in bh_fused.CUTS:
            got, s_ = bh_fused.kernel_forces(f64, *args, **kw, debug_mode=cut, pieces=pieces,
                                             cut_entry=True)
            ok = not bool(s_.any()) if cut == "none" else bool(torch.equal(s_, st))
            check(ok and (cut == "full" or not bool(got.any())), f"df {label} {cut}")
        check(torch.equal(got, full), f"df {label}: the full cut == the production entry")
        print(f"  df mode, {label}: all 7 cuts ran, stats equal full's (zero in none), full "
              "cut == production entry: True")
        if label != "random_cloud(100000)":
            print(fs.report(fs.profile(args, kw, fs.MODES, pieces=pieces),
                            f"  df {label}, pieces heaviest first [{card}]"))
    return entry


def robust_phases(torch, dev, card: str, sass: dict, arr, k1_100k, tmp: str,
                  csv1m: str) -> dict:
    """Phases [24]-[28]: K2 against its plain version and K1, and the robust
    Barnes-Hut hybrid (K6 + K1, K6 df + K4) at 1M bodies.  Returns K2's
    entry of the JSON line and K6 df's launches and evaluations on the
    robust f64 main path ([27])."""
    from nbody_tpu_torch.core.types import Bodies
    from nbody_tpu_torch.ops import bh_autold, bh_fused, bh_fused_df
    from nbody_tpu_torch.ops.cuda_exhaustive import (
        cuda_accelerations,
        cuda_potential_energy,
        cuda_rect_accelerations,
        cuda_rect_accelerations_mxu,
        rect_accelerations_mxu_reference,
    )
    from nbody_tpu_torch.ops.cuda_fp64 import (
        cuda_accelerations_f64,
        cuda_potential_energy_f64,
        cuda_rect_accelerations_f64,
    )
    from nbody_tpu_torch.utils.fixtures import (
        plummer_cloud,
        random_cloud,
        with_escapers,
        write_fixture,
    )

    f32, f64 = torch.float32, torch.float64
    n = arr.shape[0]
    b = Bodies.from_numpy(arr, dtype=f32, device=dev)

    # 24. K2 against its plain version, K1 and the fp64 formula
    print("[24] tensor-core all-pairs kernel K2 (nbody_tpu_torch/csrc/allpairs_mma.cu)")
    cuda_rect_accelerations_mxu.launches = 0
    got = cuda_accelerations(b.pos, b.mass, use_mxu=True)
    want, k2_plain_ms = timed_once(torch, lambda: rect_accelerations_mxu_reference(
        b.pos, b.pos, b.mass))
    k2_err = f32_close(torch, got, want, f"{n} x {n} against its plain version")
    f32_close(torch, got, k1_100k, f"{n} x {n} against K1")
    rows = np.sort(np.random.default_rng(0).choice(n, 256, replace=False))
    oracle = np.concatenate([fp64_forces(arr[rows[k:k + 32], :3], arr[:, :3], arr[:, 6])
                             for k in range(0, len(rows), 32)])
    rel = float(np.abs(got[torch.as_tensor(rows, device=dev)].cpu().numpy() - oracle).max()
                / np.abs(oracle).max())
    print(f"  256 targets x {n} against the fp64 formula (numpy): rel {rel:.3e} (bound 2e-3, "
          "tests/test_softening.py:163)")
    check(rel < 2e-3, "K2 against the fp64 formula")
    check(torch.equal(cuda_accelerations(b.pos, b.mass, use_mxu=True), got),
          "K2 reruns are bit-identical")
    print("  two kernel runs bit-identical: True")
    c = torch.as_tensor(random_cloud(100_003, 2), dtype=f32, device=dev)
    pi, pj, mj = c[:, :3].contiguous(), c[:4_099, :3].contiguous(), c[:4_099, 6].contiguous()
    got_u = cuda_rect_accelerations(pi, pj, mj, use_mxu=True)
    f32_close(torch, got_u, rect_accelerations_mxu_reference(pi, pj, mj),
              "100003 x 4099 against its plain version")
    f32_close(torch, got_u, cuda_rect_accelerations(pi, pj, mj), "100003 x 4099 against K1")
    e2 = torch.as_tensor(np.random.default_rng(3).uniform(1e-3, 1e-2, n), dtype=f32,
                         device=dev)
    got_pb = cuda_accelerations(b.pos, b.mass, eps2_per_body=e2, use_mxu=True)
    f32_close(torch, got_pb, rect_accelerations_mxu_reference(
        b.pos, b.pos, b.mass, eps2_i=e2, eps2_all=e2),
        f"per-body eps2 in [1e-3, 1e-2], {n} x {n}, against its plain version")
    f32_close(torch, got_pb, cuda_accelerations(b.pos, b.mass, eps2_per_body=e2),
              "per-body against K1")
    # the self-term lead (ROADMAP §3): 2,000 bodies (positions +-2, masses
    # 0.04-1, as tests/test_torch_cuda.py's _cloud), per-body eps2 in [1e-3,
    # 1e-2], targets equal to sources, against the fp64 formula with the
    # pair's softening (eps2_i + eps2_j) / 2, JAX's 2e-3 bound for its own
    # _kernel_mxu with self-terms (tests/test_softening.py:145-163)
    rng = np.random.default_rng(4000)
    p_s, m_s = rng.uniform(-2.0, 2.0, (4000, 3))[:2000], rng.uniform(0.04, 1.0, 4000)[:2000]
    e_s = np.random.default_rng(2000).uniform(1e-3, 1e-2, 4000)[:2000]
    got_s = cuda_accelerations(torch.as_tensor(p_s, dtype=f32, device=dev),
                               torch.as_tensor(m_s, dtype=f32, device=dev), G=0.7,
                               eps2_per_body=torch.as_tensor(e_s, dtype=f32, device=dev),
                               use_mxu=True).cpu().numpy()
    d_s = p_s[None, :, :] - p_s[:, None, :]
    r2_s = (d_s * d_s).sum(-1) + 0.5 * (e_s[:, None] + e_s[None, :])
    want_s = ((0.7 * m_s[None, :] * r2_s ** -1.5)[..., None] * d_s).sum(1)
    rel_s = float(np.abs(got_s - want_s).max() / np.abs(want_s).max())
    print(f"  self-terms at a small force scale (2,000 bodies, per-body eps2 from 1e-3, "
          f"targets = sources) against the fp64 formula: rel {rel_s:.3e} (bound 2e-3, "
          f"tests/test_softening.py:163)")
    check(rel_s < 2e-3, "K2 with self-terms against the fp64 formula")
    off = (b.pos + torch.tensor(OFFSET, dtype=f32, device=dev)).contiguous()
    got_o = cuda_accelerations(off, b.mass, use_mxu=True)
    f32_close(torch, got_o, rect_accelerations_mxu_reference(off, off, b.mass),
              f"cloud offset by {OFFSET}, against its plain version")
    f32_close(torch, got_o, cuda_accelerations(off, b.mass), "offset cloud against K1")
    k2_launches = cuda_rect_accelerations_mxu.launches
    print(f"  K2 launches in [24]: {k2_launches} (no CLI path takes K2, as in JAX)")
    # K2's SASS a pair (the hot loop's instructions per MUFU.RSQ, [1]), its
    # issue floor (every instruction takes an issue slot: 128 lanes an SM a
    # clock) and its MUFU floor (one MUFU.RSQ a pair, MUFU_LANES an SM a
    # clock) at n x n
    from nbody_tpu_torch.diag import sass as sa
    from nbody_tpu_torch.ops import _cuda

    sms, pairs = _cuda.sm_count(dev), float(n) ** 2
    k2_floors = {"MUFU": pairs / (MUFU_LANES * sms * CLOCK_HZ) * 1e3}
    loop = sass_of(sass, "allpairs_mma_kernelILb0", "loop")
    if loop:
        per_all, per_fp32 = sa.per(loop, "MUFU.RSQ", None), sa.per(loop, "MUFU.RSQ", sa.FP32)
        k2_floors["issue"] = issue_floor_ms(per_all, pairs, 128, sms)
        print(f"  K2 SASS a pair (hot loop per MUFU.RSQ): fp32 {per_fp32:.2f}, all issued "
              f"{per_all:.2f} (" + ", ".join(f"{k} {v / loop['MUFU.RSQ']:.2f}"
                                             for k, v in loop.most_common()) + ")")
    print(f"  K2 floors at {n} x {n}: issue "
          + (f"{k2_floors['issue']:.4f} ms" if "issue" in k2_floors else "not measured")
          + f", MUFU {k2_floors['MUFU']:.4f} ms ({sms} SMs at {CLOCK_HZ / 1e6:.0f} MHz)")
    del want, got_u, got_pb, got_o, c, pi, pj, mj, off

    # 25. robust forces at 1M
    print(f"[25] robust hybrid (K6 + K1) against exact forces: plummer_cloud({BH_N}, "
          "seed=0) with 8 bodies at r 300-1000")
    arr_r = with_escapers(plummer_cloud(BH_N, seed=0))
    br = Bodies.from_numpy(arr_r, dtype=f32, device=dev)
    counters = (bh_fused.fused_group_forces, cuda_rect_accelerations)
    for cnt in counters:
        cnt.launches = 0
    bh_fused.fused_group_forces.evaluations = 0
    acc_r, st_r = bh_fused.barneshut_fused_robust(br.pos, br.mass, return_stats=True)
    exact_r = cuda_accelerations(br.pos, br.mass)
    torch.cuda.synchronize()
    check([cnt.launches for cnt in counters] == [2, 2]
          and bh_fused.fused_group_forces.evaluations == 1, "one K6 evaluation (two "
          "launches) and one K1 launch (and K1 for the exact forces)")
    dmax_r = (acc_r - exact_r).abs().max().item()
    rel_r = dmax_r / exact_r.abs().max().item()
    own = ((acc_r[:8] - exact_r[:8]).abs().amax(dim=1) / exact_r[:8].abs().amax(dim=1))
    print(f"  max |a - exact| / max |a| = {rel_r:.4e} (bound {BH_BOUND}); escapers against "
          f"their own force scale: max {own.max().item():.4e} (bound {BH_BOUND}); robust "
          f"near bodies {int(st_r['near_bodies'])}, frontier overflow "
          f"{int(st_r['frontier_overflow'])}")
    check(rel_r < BH_BOUND and own.max().item() < BH_BOUND
          and bool(torch.isfinite(acc_r).all()), "robust forces within 0.02 of exact")
    (_, st_p), plain_ms = timed_once(torch, lambda: bh_fused.barneshut_fused(
        br.pos, br.mass, return_stats=True))
    print(f"  near bodies, plain fused against robust on this input: "
          f"{int(st_p['near_bodies'])} against {int(st_r['near_bodies'])}; one plain "
          f"evaluation {plain_ms:.4f} ms [{card}]")

    # 26. the robust main path
    print(f"[26] robust main path: {BH_N} bodies x {BH_STEPS} KDK steps, --algo auto "
          "--energy --write-every 5, f32")
    csv_r = os.path.join(tmp, "robust_1m.csv")
    write_fixture(csv_r, arr_r)
    counters = (bh_fused.fused_group_forces, bh_fused_df.fused_group_forces_df,
                cuda_rect_accelerations, cuda_rect_accelerations_f64,
                cuda_rect_accelerations_mxu, cuda_potential_energy, cuda_potential_energy_f64)

    def main_path(argv):
        for cnt in counters:
            cnt.launches = 0
        bh_fused.fused_group_forces.evaluations = 0
        bh_fused_df.fused_group_forces_df.evaluations = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, text, err = run_cli_rc(argv)
        torch.cuda.synchronize()
        check(rc == 0, f"CLI exit code {rc} for {argv}")
        return text, err, time.perf_counter() - t0, [cnt.launches for cnt in counters]

    out_r = os.path.join(tmp, "robust.csv")
    text, err, wall, launches = main_path([csv_r, *BH_WINDOW, out_r, "--energy",
                                           "--write-every", "5", "--algo", "auto"])
    k6_l, k6df_l, k1_l, k4_l, k2_l, k3_l, k5_l = launches
    k6_e = bh_fused.fused_group_forces.evaluations
    print(f"  launches: K6 {k6_l} in {k6_e} evaluations, K1 {k1_l} (want {BH_STEPS + 1} "
          f"evaluations, K6 two launches each and one for the probe), potential {k3_l} "
          f"(want 2), K6 df {k6df_l}, K4 {k4_l}, K2 {k2_l}, K5 {k5_l} (want 0); whole CLI "
          f"call {wall:.4f} s")
    check("enabling --bh-robust on" in err and "data-adaptive grid depth picked" in err,
          "the robust hybrid and the depth pricer engaged")
    check("Algorithm: barnes-hut, backend: cuda/fused/robust, dtype: f32" in text,
          "the banner names the robust hybrid")
    check(k6_e == k1_l == BH_STEPS + 1 and k6_l == 2 * k6_e + 1 and k3_l == 2,
          "K6 / K1 / K3 launches")
    check(k6df_l == k4_l == k2_l == k5_l == 0, "no other kernel")
    frames_r = load_frames(out_r, BH_N, frames=2)
    drift_r = cli_number(text, "Relative energy drift:")
    out_x = os.path.join(tmp, "robust_ex.csv")
    text_x, _, _, _ = main_path([csv_r, *BH_WINDOW, out_x, "--energy", "--write-every", "5",
                                 "--algo", "exhaustive"])
    frames_x = load_frames(out_x, BH_N, frames=2)
    drift_x = cli_number(text_x, "Relative energy drift:")
    t_bh = BH_STEPS * BH_DT
    pos_bound = dmax_r * t_bh * t_bh + 2e-6
    dpos = float(np.abs(frames_r[-1, :, 1:4] - frames_x[-1, :, 1:4]).max())
    print(f"  final positions against the exhaustive run's max |diff| {dpos:.3e} (bound "
          f"{pos_bound:.3e}); drift robust {drift_r:.6e} vs exhaustive {drift_x:.6e}, |diff| "
          f"{abs(drift_r - drift_x):.3e} (bound 1e-3)")
    check(dpos < pos_bound, "robust final positions agree with the exhaustive run")
    check(abs(drift_r - drift_x) < 1e-3, "robust drift agrees with the exhaustive run")
    del frames_r, frames_x

    # 27. the same with --dtype f64
    print(f"[27] robust main path, --dtype f64 (K6 df + K4)")
    text, err, wall, launches = main_path([csv_r, *BH_WINDOW, os.path.join(tmp, "r64.csv"),
                                           "--energy", "--write-every", "5", "--algo", "auto",
                                           "--dtype", "f64"])
    k6_l, k6df_l, k1_l, k4_l, k2_l, k3_l, k5_l = launches
    k6df_e = bh_fused_df.fused_group_forces_df.evaluations
    print(f"  launches: K6 df {k6df_l} in {k6df_e} evaluations, K4 {k4_l} (want "
          f"{BH_STEPS + 1} evaluations and K4 launches, K6 df two launches each and one for "
          f"the probe), fp64 "
          f"potential {k5_l} (want 2), K6 {k6_l}, K1 {k1_l}, K2 {k2_l}, K3 {k3_l} (want 0); "
          f"whole CLI call {wall:.4f} s")
    check("backend: cuda/fused/robust, dtype: f64" in text, "the f64 robust banner")
    check(k6df_e == k4_l == BH_STEPS + 1 and k6df_l == 2 * k6df_e + 1 and k5_l == 2,
          "K6 df / K4 / K5 launches")
    k6df_r64, k6df_e64 = k6df_l, k6df_e
    check(k6_l == k1_l == k2_l == k3_l == 0, "no f32 kernel on the f64 path")
    drift_r64 = cli_number(text, "Relative energy drift:")
    print(f"  drift f64 {drift_r64:.6e} against the f32 run's {drift_r:.6e}, |diff| "
          f"{abs(drift_r64 - drift_r):.3e} (bound 1e-3)")
    check(abs(drift_r64 - drift_r) < 1e-3, "f64 and f32 robust drifts agree")
    br64 = Bodies.from_numpy(arr_r, dtype=f64, device=dev)
    acc64 = bh_fused_df.barneshut_fused_robust_df(br64.pos, br64.mass)
    exact64 = cuda_accelerations_f64(br64.pos, br64.mass)
    torch.cuda.synchronize()
    rel64 = (acc64 - exact64).abs().max().item() / exact64.abs().max().item()
    print(f"  barneshut_fused_robust_df against K4's exact forces: max |a - exact| / max |a| "
          f"= {rel64:.4e} (bound {BH_BOUND}; f32 {rel_r:.4e})")
    check(rel64 < BH_BOUND and bool(torch.isfinite(acc64).all()),
          "f64 robust forces within 0.02 of exact")
    del br64, acc64, exact64

    # 28. times and the H100 unit costs of the depth pricer
    print(f"[28] timing on {card}")
    k2_ms = cuda_ms(torch, lambda: cuda_accelerations(b.pos, b.mass, use_mxu=True), 10)
    k1_ms = cuda_ms(torch, lambda: cuda_accelerations(b.pos, b.mass), 10)
    pairs = float(n) ** 2
    nbytes = (2 * n * 3 + n + n * 3) * 4
    t_bytes, t_cc, t_tc = nbytes / HBM_BPS, pairs * K2_OPS / FP32_PEAK, (
        pairs * K2_TC_FLOPS / TF32_PEAK)
    k2_bound = (max(t_bytes, t_cc, t_tc) * 1e3,
                "bytes" if t_bytes > max(t_cc, t_tc) else "operations")
    print(f"  K2 {n}x{n}: {k2_ms:.4f} ms ({pairs / k2_ms / 1e-3:.4e} pairs/s), K1 {k1_ms:.4f} "
          f"ms in the same call; K2's bound {k2_bound[0]:.4f} ms ({k2_bound[1]}: {K2_OPS} "
          f"CUDA-core operations a pair at 67 TFLOP/s {t_cc * 1e3:.4f} ms, the contraction "
          f"{K2_TC_FLOPS} flops a pair at 495 TF32 TFLOP/s {t_tc * 1e3:.4f} ms), "
          f"{k2_ms / k2_bound[0]:.2f}x it; plain {k2_plain_ms:.4f} ms (one run) [{card}]")
    print(f"  K2 before the redesign {BEFORE_MS['K2 100k']} ms "
          f"({k2_ms / BEFORE_MS['K2 100k']:.3f}x); "
          + "; ".join(f"{k} floor {v:.4f} ms ({v / k2_ms:.0%} of the time)"
                      for k, v in k2_floors.items()) + f" [{card}]")
    center, border, out_idx = bh_fused.robust_box(br.pos)
    box_ms = cuda_ms(torch, lambda: bh_fused.robust_box(br.pos), 10)
    t0 = time.perf_counter()
    ld_pick, costs = bh_autold.choose_ld(arr_r[:, 0:3], arr_r[:, 6], robust=True)
    probe_s = time.perf_counter() - t0
    rel = br.pos - center
    mass_bh = br.mass.index_fill(0, out_idx, 0.0)
    fi = bh_fused.prepare_fused(rel, mass_bh, ld=ld_pick, border=border)
    kw = dict(theta=0.5, eps2=0.01, leaf_cap=64, ld=fi.ld, group_size=fi.group_size)
    k6args = (fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq)
    prep_ms = cuda_ms(torch, lambda: bh_fused.prepare_fused(rel, mass_bh, ld=ld_pick,
                                                            border=border), 5)
    k6_ms = cuda_ms(torch, lambda: bh_fused.fused_group_forces(*k6args, **kw), 5)
    src_o, m_o = br.pos[out_idx].contiguous(), br.mass[out_idx].contiguous()
    rect_ms = cuda_ms(torch, lambda: cuda_rect_accelerations(br.pos, src_o, m_o), 5)
    whole_ms = cuda_ms(torch, lambda: bh_fused.barneshut_fused_robust(br.pos, br.mass,
                                                                      ld=ld_pick), 5)
    print(f"  one robust evaluation at {BH_N} (ld {ld_pick}, K {out_idx.numel()}): whole "
          f"{whole_ms:.4f} ms; box {box_ms:.4f} ms + sort+build+groups {prep_ms:.4f} ms + K6 "
          f"{k6_ms:.4f} ms + K1 rectangle ({BH_N} x {out_idx.numel()}) {rect_ms:.4f} ms "
          f"(parts timed apart); the depth probe (host, once per input) {probe_s:.4f} s "
          f"[{card}]")
    # the f64 robust evaluation: K6 df over depths beside the K4 rectangle
    # (the depth pricer's unit costs are K6 f32's: is ld 8 the df argmin too?)
    from nbody_tpu_torch.diag import fused_stages as fs
    br64 = Bodies.from_numpy(arr_r, dtype=f64, device=dev)
    rect64_ms = cuda_ms(torch, lambda: cuda_rect_accelerations_f64(
        br64.pos, br64.pos[out_idx].contiguous(), br64.mass[out_idx].contiguous()), 5)
    whole64_ms = cuda_ms(torch, lambda: bh_fused_df.barneshut_fused_robust_df(
        br64.pos, br64.mass, ld=ld_pick), 3)
    print(f"  one f64 robust evaluation (ld {ld_pick}): whole {whole64_ms:.4f} ms; K4 "
          f"rectangle ({BH_N} x {out_idx.numel()}) {rect64_ms:.4f} ms [{card}]")
    for ld in (5, 6, 7, 8):
        a_, kw_ = fs.robust_inputs(BH_N, dev, ld=ld, dtype=f64)
        ms = cuda_ms(torch, lambda: bh_fused_df.fused_group_forces_df(*a_, **kw_), 3)
        print(f"  f64 robust ld {ld}: K6 df {ms:.4f} ms [{card}]")
    del br64, a_
    # unit costs: K6 time and its pops - none stage-cut increment against its
    # stats lanes, set-up time against the dense-grid nodes, over depths of
    # this input and of the uniform cloud
    from nbody_tpu_torch.diag.fused_stages import best_ms
    points, builds = [], []
    b1m = Bodies.from_numpy(random_cloud(BH_N, seed=0), dtype=f32, device=dev)
    for label, (p_, m_, bd_), lds in (("robust", (rel, mass_bh, border), (5, 6, 7, 8)),
                                       ("uniform", (b1m.pos, b1m.mass, None), (4, 5, 6, 7))):
        for ld in lds:
            fi = bh_fused.prepare_fused(p_, m_, ld=ld, border=bd_)
            kw = dict(theta=0.5, eps2=0.01, leaf_cap=64, ld=ld, group_size=fi.group_size,
                      frontier_cap=bh_fused.FRONTIER_CAP)
            a_ = (fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq)
            _, st = bh_fused.fused_group_forces(*a_, **kw)
            ms = cuda_ms(torch, lambda: bh_fused.fused_group_forces(*a_, **kw), 3)
            cut = {c: best_ms(lambda: bh_fused.kernel_forces(f32, *a_, **kw, debug_mode=c))
                   for c in ("none", "pops")}
            pm = cuda_ms(torch, lambda: bh_fused.prepare_fused(p_, m_, ld=ld, border=bd_), 3)
            staged = float(st[:, bh_fused.S_SRC].double().sum().item())
            classified = 8.0 * float(st[:, bh_fused.S_POPS].double().sum().item())
            nodes = (8 ** (ld + 1) - 1) // 7
            points.append((ms, staged, classified, cut["pops"] - cut["none"]))
            builds.append((label, nodes, pm))
            print(f"  {label} ld {ld}: K6 {ms:.4f} ms, cuts none {cut['none']:.4f} ms, pops "
                  f"{cut['pops']:.4f} ms; staged sources {staged:.4e}, classified cells "
                  f"(8 x pops) {classified:.4e}; set-up {pm:.4f} ms over {nodes} nodes")
    ns_src, ns_pop = fit_unit_costs(points)
    rb = [(nd, pm) for label, nd, pm in builds if label == "robust"]
    ns_node = max(0.0, float(np.polyfit([nd for nd, _ in rb], [pm * 1e6 for _, pm in rb],
                                        1)[0]))
    print(f"  H100 unit costs: NS_PER_SOURCE {ns_src:.4f}, NS_PER_POP {ns_pop:.4f} (per 128 "
          f"classified cells, from the pops - none cuts), NS_PER_BUILD_NODE {ns_node:.4f} "
          f"(the port's now: {bh_autold.NS_PER_SOURCE}, {bh_autold.NS_PER_POP}, "
          f"{bh_autold.NS_PER_BUILD_NODE}) [{card}]")
    del fi, k6args, points
    rc, text, _ = run_cli_rc([csv_r, *BH_WINDOW, os.path.join(tmp, "x.csv"), "--no-output",
                              "--algo", "auto"])
    check(rc == 0, f"robust --no-output exit code {rc}")
    sim = cli_number(text, "Elapsed wall time:")
    print(f"  {BH_N} Plummer with escapers --no-output --algo auto (robust): simulate "
          f"{sim:.4f} s -> {sim / BH_STEPS:.4f} s/step [{card}]")
    for robust in ("off", "on", "on", "off"):
        rc, text, _ = run_cli_rc([csv1m, *BH_WINDOW, os.path.join(tmp, "x.csv"), "--no-output",
                                  "--algo", "auto", "--bh-robust", robust])
        check(rc == 0, f"--bh-robust {robust} --no-output exit code {rc}")
        sim = cli_number(text, "Elapsed wall time:")
        print(f"  {BH_N} uniform --no-output --bh-robust {robust}: simulate {sim:.4f} s -> "
              f"{sim / BH_STEPS:.4f} s/step [{card}]")
    return {"name": "allpairs_mma_f32", "route": "cuda",
            "source": "nbody_tpu_torch/csrc/allpairs_mma.cu",
            "replaces": "nbody_tpu/ops/pallas_exhaustive.py:80",
            "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms,
            "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
            "library_ms": None}, {"launches": k6df_r64, "evaluations": k6df_e64}


# [30]-[32]: 20 KDK steps for the --no-output s/step turns (C-float count)
TURN_WINDOW = ["0", "0.002", "0.0001"]
RESORT_EVERY = 4


def table_node_fit(torch, bp, pos, vel, mass, lds, robust_slots: int, label: str,
                   card: str) -> float:
    """The persistent layout's per-step table rebuild (``_ft_from_state``)
    timed at each depth in `lds` on these bodies, and its slope in ns per
    dense-grid node by least squares: the depth pricer's
    NS_PER_TABLE_NODE."""
    nodes, ms = [], []
    for ld in lds:
        st = bp.init_state(pos, vel, mass, G=1.0, robust_slots=robust_slots, ld=ld)
        ms.append(cuda_ms(torch, lambda: bp._ft_from_state(st), 10))
        nodes.append((8 ** (ld + 1) - 1) // 7)
        print(f"  {label} ld {ld}: table rebuild {ms[-1]:.4f} ms over {nodes[-1]} nodes "
              f"({st.src.shape[0]} slots) [{card}]")
    del st
    slope = float(np.polyfit(nodes, [m * 1e6 for m in ms], 1)[0])
    print(f"  {label}: NS_PER_TABLE_NODE fit {slope:.4f} ns per node over ld "
          f"{lds[0]}-{lds[-1]} [{card}]")
    return slope


def persistent_split(torch, bp, bh_fused, st, kw: dict, dt: float) -> dict:
    """One persistent step's parts, device ms (CUDA events, mean of 10 after
    a warm-up): the table rebuild, K6 (pricing pass and full kernel), the
    outliers' K1 rectangle in robust mode, kick and drift, the whole step,
    and one resort.  Steps run on a copy of the state."""
    from nbody_tpu_torch.ops.cuda_exhaustive import cuda_rect_accelerations

    tree = bp._ft_from_state(st)
    b = st.group_size
    gstart = torch.arange(0, st.src.shape[0], b, dtype=torch.int32, device=st.src.device)
    out = {"rebuild": cuda_ms(torch, lambda: bp._ft_from_state(st), 10),
           "K6": cuda_ms(torch, lambda: bh_fused.fused_group_forces(
               tree, gstart, st.gcount, st.src, st.bsq, theta=kw["theta"],
               eps2=kw["softening_sq"], leaf_cap=kw["leaf_cap"], ld=st.ld, group_size=b), 10)}
    if st.out_gm is not None:
        targets = st.src[:, :3].contiguous()
        src_o = targets[st.out_slots].contiguous()
        out["K1 rectangle"] = cuda_ms(torch, lambda: cuda_rect_accelerations(
            targets, src_o, st.out_gm, G=1.0, softening_sq=kw["softening_sq"]), 10)
    work = st._replace(src=st.src.clone(), vel=st.vel.clone())
    half = dt * 0.5

    def kick_drift():
        work.vel.add_(work.acc * half)
        work.src[:, :3] += work.vel * dt
        work.vel.add_(work.acc * half)

    out["kick+drift"] = cuda_ms(torch, kick_drift, 10)
    out["whole step"] = cuda_ms(torch, lambda: bp.kdk_steps(work, 1, dt, **kw), 10)
    out["resort"] = cuda_ms(torch, lambda: bp.resort(st, 0 if st.out_gm is None
                                                     else st.out_slots.numel()), 10)
    return out


def profile_line(torch, fn, label: str, card: str) -> None:
    """Print one profiled call of `fn` (after a warm-up): its wall time, the
    kernels' device time and busy share, the kernel launches and the three
    costliest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:3]
    print(f"  profile of {label}: wall {wall_ms:.4f} ms (profiled), kernels {device_ms:.4f} "
          f"ms on the device, busy share {device_ms / wall_ms:.3f}, {launches} kernel "
          "launches; top: " + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.4f} ms"
                                        for e in top) + f" [{card}]")


def split_line(parts: dict, k: int) -> str:
    amort = parts["whole step"] + parts["resort"] / k
    return (" + ".join(f"{name} {parts[name]:.4f}" for name in parts
                       if name not in ("whole step", "resort"))
            + f" ms (parts timed apart); one whole step {parts['whole step']:.4f} ms; one "
            f"resort {parts['resort']:.4f} ms; a step with a resort every {k} steps "
            f"{amort:.4f} ms")


def no_output_turns(csv: str, tmp: str, card: str, label: str) -> None:
    """--no-output s/step over TURN_WINDOW in turns one-shot, persistent,
    persistent, one-shot (each its own CLI call in this process)."""
    for persistent in (False, True, True, False):
        flags = ["--resort-every", str(RESORT_EVERY)] if persistent else []
        text = run_cli([csv, *TURN_WINDOW, os.path.join(tmp, "x.csv"), "--no-output",
                        "--algo", "auto", *flags])
        steps = int(re.search(r"time steps: (\d+)", text).group(1))
        sim = cli_number(text, "Elapsed wall time:")
        how = f"--resort-every {RESORT_EVERY}" if persistent else "one-shot"
        print(f"  {label} --no-output {how}: simulate {sim:.4f} s over {steps} steps -> "
              f"{sim / steps:.5f} s/step [{card}]")


def persistent_phases(torch, dev, card: str, b1m, csv1m: str, tmp: str, frames_bh,
                      drift_bh: float, dmax: float, oneshot: dict) -> dict:
    """Phases [30]-[32]: the persistent Morton layout at 1M bodies, uniform
    ([30]) and robust ([31]), and the CLI's report flags ([32]).  Returns
    the launches of the persistent main paths (K6 and K1)."""
    from nbody_tpu_torch.core.types import Bodies
    from nbody_tpu_torch.ops import bh_autold, bh_fused
    from nbody_tpu_torch.ops import bh_persistent as bp
    from nbody_tpu_torch.ops.cuda_exhaustive import (
        cuda_accelerations,
        cuda_potential_energy,
        cuda_rect_accelerations,
    )
    from nbody_tpu_torch.utils.fixtures import plummer_cloud, with_escapers

    f32 = torch.float32
    kw = dict(theta=0.5, softening_sq=0.01, leaf_cap=64)
    counters = (bh_fused.fused_group_forces, cuda_rect_accelerations, cuda_potential_energy)

    def main_path(argv):
        for c in counters:
            c.launches = 0
        bh_fused.fused_group_forces.evaluations = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (text, wall, [c.launches for c in counters],
                bh_fused.fused_group_forces.evaluations)

    # 30. the persistent layout on the uniform cloud
    print(f"[30] persistent Morton layout (nbody_tpu_torch/ops/bh_persistent.py): {BH_N} "
          f"bodies (random_cloud seed 0) x {BH_STEPS} KDK steps, --algo auto --resort-every "
          f"{RESORT_EVERY} --energy --write-every 5")
    out_p = os.path.join(tmp, "persistent.csv")
    text, wall, (k6_l, k1_l, k3_l), k6_e = main_path(
        [csv1m, *BH_WINDOW, out_p, "--energy", "--write-every", "5", "--algo", "auto",
         "--resort-every", str(RESORT_EVERY)])
    print(f"  launches: K6 {k6_l} in {k6_e} evaluations (want {BH_STEPS + 1}: the first "
          f"evaluation and {BH_STEPS} steps, two launches each, and the one-shot probe's "
          f"pricing launch), K1 {k1_l} "
          f"(want 0), potential {k3_l} (want 2); whole CLI call {wall:.4f} s")
    check("backend: cuda/fused/persistent, dtype: f32" in text,
          "--resort-every took the persistent layout")
    check(k6_e == BH_STEPS + 1 and k6_l == 2 * k6_e + 1 and k1_l == 0 and k3_l == 2,
          "persistent K6 / K1 / K3 launches")
    persistent_launches = k6_l
    frames_p = load_frames(out_p, BH_N, frames=2)
    drift_p = cli_number(text, "Relative energy drift:")
    t_bh = BH_STEPS * BH_DT
    pos_bound = dmax * t_bh * t_bh + 2e-6
    dpos = float(np.abs(frames_p[-1, :, 1:4] - frames_bh[-1, :, 1:4]).max())
    print(f"  final positions against the one-shot run's ([9]) max |diff| {dpos:.3e} (bound "
          f"max|da| T^2 + 2e-6 = {pos_bound:.3e}); drift persistent {drift_p:.6e} vs "
          f"one-shot {drift_bh:.6e}, |diff| {abs(drift_p - drift_bh):.3e} (bound 1e-3)")
    check(dpos < pos_bound, "persistent final positions agree with the one-shot run")
    check(abs(drift_p - drift_bh) < 1e-3, "persistent drift agrees with the one-shot run")
    del frames_p

    st = bp.init_state(b1m.pos, b1m.vel, b1m.mass, G=1.0)
    st, stats = bp.prime(st, **kw)
    st, ovf, _ = bp.kdk_steps(st, RESORT_EVERY, BH_DT, **kw)
    check(int(ovf) == 0 and int(stats[:, bh_fused.S_OVF].max()) == 0, "no frontier overflow")
    sample = st.real[::97]
    pos_r = st.src[st.real, :3].contiguous()
    exact = cuda_rect_accelerations(st.src[sample, :3].contiguous(), pos_r,
                                    st.src[st.real, 3].contiguous(), G=1.0)
    rel = ((st.acc[sample] - exact).abs().max() / exact.abs().max()).item()
    print(f"  forces after {RESORT_EVERY} unsorted steps (ld {st.ld}, {st.gcount.shape[0]} "
          f"groups of {st.group_size} slots, {st.src.shape[0]} slots) against exact on "
          f"{sample.numel()} sampled bodies: max |a - exact| / max |a| = {rel:.4e} "
          f"(bound {BH_BOUND})")
    check(rel < BH_BOUND and bool(torch.isfinite(st.acc[st.real]).all()),
          "persistent forces within 0.02 of exact")
    acc1, s1 = bp.state_forces(st, **kw)
    acc2, s2 = bp.state_forces(st, **kw)
    check(torch.equal(acc1, acc2) and torch.equal(s1, s2),
          "persistent evaluations rerun bit-identical")
    print("  two persistent evaluations bit-identical: True")
    parts = persistent_split(torch, bp, bh_fused, st, kw, BH_DT)
    print(f"  one persistent step at {BH_N}: " + split_line(parts, RESORT_EVERY) + f" [{card}]")
    print(f"  one one-shot evaluation at {BH_N} ([11]): whole {oneshot['whole']:.4f} ms = "
          f"set-up {oneshot['set-up']:.4f} + K6 {oneshot['K6']:.4f} + scatter "
          f"{oneshot['scatter']:.4f} ms (parts timed apart) [{card}]")
    # where a chunk's time goes: RESORT_EVERY persistent steps and their
    # resort, against as many one-shot KDK steps
    from nbody_tpu_torch.integrate.leapfrog import leapfrog_steps

    def chunk():
        work = st._replace(src=st.src.clone(), vel=st.vel.clone())
        work, _, _ = bp.kdk_steps(work, RESORT_EVERY, BH_DT, **kw)
        bp.resort(work)

    profile_line(torch, chunk, f"{RESORT_EVERY} persistent steps and a resort", card)
    acc0 = torch.zeros_like(b1m.pos)  # the carry's value does not change the work
    profile_line(torch, lambda: leapfrog_steps(b1m, RESORT_EVERY, BH_DT,
                                               bh_fused.barneshut_fused, acc0=acc0),
                 f"{RESORT_EVERY} one-shot steps", card)
    no_output_turns(csv1m, tmp, card, f"{BH_N} uniform")
    del st, acc1, acc2, exact, pos_r
    table_node_fit(torch, bp, b1m.pos, b1m.vel, b1m.mass, (5, 6, 7, 8), 0, "uniform", card)

    # 31. the robust persistent layout
    k_out = max(128, BH_N // 512)
    print(f"[31] robust persistent layout: plummer_cloud({BH_N}, seed=0) with 8 escapers, "
          f"--algo auto --resort-every {RESORT_EVERY} (K6 + K1 every step, K = {k_out})")
    arr_r = with_escapers(plummer_cloud(BH_N, seed=0))
    csv_r = os.path.join(tmp, "robust_1m.csv")
    check(os.path.exists(csv_r), "[26] wrote the robust input")
    br = Bodies.from_numpy(arr_r, dtype=f32, device=dev)
    t0 = time.perf_counter()
    ld_p, _ = bh_autold.choose_ld(arr_r[:, 0:3], arr_r[:, 6], robust=True, persistent=True)
    ld_o, _ = bh_autold.choose_ld(arr_r[:, 0:3], arr_r[:, 6], robust=True)
    print(f"  the depth pricer's pick: ld {ld_p} persistent, ld {ld_o} one-shot "
          f"(NS_PER_TABLE_NODE {bh_autold.NS_PER_TABLE_NODE}; {time.perf_counter() - t0:.2f} "
          "s, host)")
    for c in counters:
        c.launches = 0
    st = bp.init_state(br.pos, br.vel, br.mass, G=1.0, robust_slots=k_out, ld=ld_p)
    st, _ = bp.prime(st, **kw)
    torch.cuda.synchronize()
    check([c.launches for c in counters[:2]] == [2, 1], "one K6 evaluation and one K1 launch")
    acc = torch.empty_like(br.pos)
    acc[st.orig[st.real].long()] = st.acc[st.real]
    exact_r = cuda_accelerations(br.pos, br.mass)
    rel_r = ((acc - exact_r).abs().max() / exact_r.abs().max()).item()
    own = ((acc[:8] - exact_r[:8]).abs().amax(dim=1) / exact_r[:8].abs().amax(dim=1))
    print(f"  first evaluation (ld {st.ld}): max |a - exact| / max |a| = {rel_r:.4e} (bound "
          f"{BH_BOUND}); escapers against their own force scale: max "
          f"{own.max().item():.4e} (bound {BH_BOUND})")
    check(rel_r < BH_BOUND and own.max().item() < BH_BOUND
          and bool(torch.isfinite(acc).all()), "robust persistent forces within 0.02 of exact")
    acc1, _ = bp.state_forces(st, **kw)
    check(torch.equal(acc1, st.acc), "robust persistent evaluations rerun bit-identical")
    del exact_r, acc, acc1
    parts = persistent_split(torch, bp, bh_fused, st, kw, BH_DT)
    print(f"  one robust persistent step: " + split_line(parts, RESORT_EVERY) + f" [{card}]")
    del st
    text, wall, (k6_l, k1_l, _), k6_e = main_path(
        [csv_r, *TURN_WINDOW, os.path.join(tmp, "x.csv"), "--no-output", "--algo", "auto",
         "--resort-every", str(RESORT_EVERY)])
    steps = int(re.search(r"time steps: (\d+)", text).group(1))
    print(f"  robust persistent main path over {steps} steps: K6 {k6_l} in {k6_e} evaluations, "
          f"K1 {k1_l} (want {steps + 1} each: the first evaluation and {steps} steps; K6 "
          f"one more launch, the one-shot probe's pricing); simulate {cli_number(text, 'Elapsed wall time:'):.4f} s, whole "
          f"CLI call {wall:.4f} s [{card}]")
    check("backend: cuda/fused/robust/persistent, dtype: f32" in text,
          "the robust persistent layout ran")
    check(k6_e == k1_l == steps + 1 and k6_l == 2 * k6_e + 1, "robust persistent launches")
    robust_launches = (k6_l, k1_l)
    no_output_turns(csv_r, tmp, card, f"{BH_N} Plummer with escapers (robust)")
    ns_node = table_node_fit(torch, bp, br.pos, br.vel, br.mass, (5, 6, 7, 8), k_out,
                             "robust", card)
    print(f"  the port's NS_PER_TABLE_NODE now: {bh_autold.NS_PER_TABLE_NODE}; this "
          f"card's fit on the robust input {ns_node:.4f} [{card}]")
    del br

    # 32. the report flags
    print(f"[32] --timers, --trace, --devices [{card}]")
    for flags in (["--algo", "auto"], ["--algo", "barnes-hut", "--bh-traversal", "flat"]):
        text = run_cli([csv1m, "0", "0.0001", "0.0001", os.path.join(tmp, "x.csv"),
                        "--no-output", "--timers", *flags])
        check("Per-phase force-eval breakdown:" in text, "--timers printed its report")
        ratio = cli_number(text, "phases / total")
        print(f"  {' '.join(flags)}: the phases sum to {ratio:.4f} of one whole evaluation "
              f"[{card}]")
        check(abs(ratio - 1.0) < 0.1, "the phases sum to within 10 % of one whole evaluation")
    # the trace in a process of its own, as a user runs it: in this one,
    # after [23]'s and [30]'s profiles, torch.profiler (torch 2.11 on an
    # H100) recorded no device kernel
    tdir = os.path.join(tmp, "trace")
    r = subprocess.run([sys.executable, "-m", "nbody_tpu_torch", CSV_100K, "0", "0.0001",
                        "0.0001", os.path.join(tmp, "x.csv"), "--no-output", "--trace", tdir],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"--trace run exit code {r.returncode}: {r.stderr[-400:]}")
    path = os.path.join(tdir, "trace.json")
    check(os.path.exists(path), "--trace wrote a trace")
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kern = [e for e in events if e.get("cat") == "kernel"]
    k1_dev = sum(e.get("dur", 0) for e in kern if "allpairs" in e.get("name", "")) / 1e3
    print(f"  --trace: {os.path.getsize(path)} bytes, {len(events)} events, {len(kern)} "
          f"device kernels, K1 {k1_dev:.4f} ms on the device (two launches) [{card}]")
    check(len(kern) > 0, "the trace holds device kernels")
    text = run_cli([CSV_10, "0", "0.1", "0.1", os.path.join(tmp, "x.csv"), "--no-output",
                    "--devices"])
    check(torch.cuda.get_device_name(0) in text and " SMs, " in text,
          "--devices printed the card")
    return {"K6 persistent": persistent_launches, "K6 robust persistent": robust_launches[0],
            "K1 robust persistent": robust_launches[1]}


# [33]-[36]: checkpoint and resume, adaptive dt, merging, block tiers
MERGE_SEED, MERGE_RADIUS = 7, 0.005  # ~40 pairs in contact in the 100k clump
MERGE_MASS = 2.0**-17  # equal masses: a root's sum is exact in f32


# Two runs of one integration agree on the energy drift within 5 % of it,
# plus the f32 resolution of the energies it is read from (~1e-7 of E).
DRIFT_REL, DRIFT_ABS = 0.05, 5e-7


def drifts_agree(got: float, want: float) -> bool:
    return abs(got - want) <= DRIFT_REL * abs(want) + DRIFT_ABS


def _write7(path: str, arr: np.ndarray) -> None:
    """Write bodies in the input format through the native writer (the
    Python one takes ~5 s at 1M)."""
    from nbody_tpu_torch.native import loader

    lib = loader.get()
    check(lib is not None and lib.write7(path, arr), f"native write7 of {path}")


def _same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def option_phases(torch, dev, card: str, b, b1m, csv1m: str, tmp: str, frames_bh,
                  dmax: float, n_small: int = 100_000, csv_small: str = CSV_100K,
                  n_big: int = BH_N) -> dict:
    """Phases [33]-[36]: checkpoint and resume, adaptive dt, merging and the
    block time-step tiers, through the CLI on the hand-written kernels
    (K1 one-shot, K6 on the persistent layout), each checked against the
    uninterrupted, plain or one-shot run.  Returns the launches and times
    of the kernels line."""
    from nbody_tpu_torch.core.types import Bodies
    from nbody_tpu_torch.integrate.adaptive import adaptive_steps, simulate_adaptive
    from nbody_tpu_torch.io.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
    from nbody_tpu_torch.ops import bh_fused
    from nbody_tpu_torch.ops import bh_persistent as bp
    from nbody_tpu_torch.ops.collisions import merge_pass
    from nbody_tpu_torch.ops.cuda_exhaustive import (
        cuda_accelerations,
        cuda_potential_energy,
        cuda_rect_accelerations,
    )
    from nbody_tpu_torch.ops.exhaustive import exhaustive_accelerations
    from nbody_tpu_torch.utils.fixtures import random_cloud, stratified_cloud

    f32 = np.float32
    out = {}
    x = os.path.join(tmp, "x.csv")

    def counted(argv):
        """run_cli with K1's, K6's and K3's counters set to 0 just before
        and read just after: (stdout, K1 launches, K6 launches, K6
        evaluations, simulate wall s)."""
        for c in (cuda_rect_accelerations, bh_fused.fused_group_forces, cuda_potential_energy):
            c.launches = 0
        bh_fused.fused_group_forces.evaluations = 0
        text = run_cli(argv)
        return (text, cuda_rect_accelerations.launches, bh_fused.fused_group_forces.launches,
                bh_fused.fused_group_forces.evaluations, cli_number(text, "Elapsed wall time:"))

    # 33. checkpoint and resume
    print(f"[33] checkpoint and resume: {n_small} bodies x {STEPS} KDK steps (K1), "
          f"--checkpoint-every 5, then --resume from step 5 [{card}]")
    full, part = os.path.join(tmp, "ck_full.csv"), os.path.join(tmp, "ck_part.csv")
    ck_full, ck_a, ck_b = (os.path.join(tmp, f"ck_{k}.ckpt.csv") for k in ("f", "a", "b"))
    run_cli([csv_small, *MAIN_WINDOW, full, "--checkpoint-every", "5", "--checkpoint", ck_full])
    run_cli([csv_small, "0", "0.0005", "0.0001", part, "--checkpoint-every", "5",
             "--checkpoint", ck_a])
    _, meta = load_checkpoint(ck_a)
    check(meta.get("step") == 5, f"the step-5 checkpoint's sidecar {meta}")
    text, k1_resume, _, _, _ = counted([ck_a, *MAIN_WINDOW, part, "--resume",
                                        "--checkpoint-every", "5", "--checkpoint", ck_b])
    check("Resuming from" in text and k1_resume == 6, f"resumed run: K1 {k1_resume} (want 6)")
    same_frames, same_state = _same_file(part, full), _same_file(ck_b, ck_full)
    same_meta = _same_file(ck_b + ".meta.json", ck_full + ".meta.json")
    print(f"  frames byte-identical to the uninterrupted run: {same_frames}; final state "
          f"(step-10 checkpoints) byte-identical: {same_state}, sidecars {same_meta}; K1 "
          f"launches in the resumed run {k1_resume}")
    check(same_frames and same_state and same_meta, "the resumed 100k run is byte-identical")
    out["K1 resume"] = k1_resume
    ck4, ck5 = os.path.join(tmp, "ck1m_4.ckpt.csv"), os.path.join(tmp, "ck1m_5.ckpt.csv")
    pflags = ["--no-output", "--algo", "auto", "--resort-every", str(RESORT_EVERY)]
    run_cli([csv1m, "0", "0.0004", "0.0001", x, *pflags, "--checkpoint-every", "4",
             "--checkpoint", ck4])
    text, _, k6_l, k6_e, _ = counted([ck4, *BH_WINDOW, x, *pflags, "--resume",
                                      "--checkpoint-every", "1", "--checkpoint", ck5])
    arr5, meta5 = load_checkpoint(ck5)
    t_bh = BH_STEPS * BH_DT
    pos_bound = dmax * t_bh * t_bh + 2e-6
    dpos = float(np.abs(arr5[:, :3] - frames_bh[-1, :, 1:4]).max())
    print(f"  1M --resort-every {RESORT_EVERY}: checkpoint at step 4, resumed for one step "
          f"(K6 {k6_l} launches in {k6_e} evaluations, sidecar {meta5}); final state against "
          f"the one-shot run's ([9]) max |diff| {dpos:.3e} (bound {pos_bound:.3e}, [30]'s)")
    check("/persistent" in text and meta5.get("step") == BH_STEPS and dpos < pos_bound,
          "the resumed persistent run agrees with the one-shot run")
    path = os.path.join(tmp, "w1m.ckpt.csv")
    t0 = time.perf_counter()
    save_checkpoint(path, b1m, step=1, time=0.0001)
    t_save = time.perf_counter() - t0
    with CheckpointManager(path, keep=2) as mgr:
        t0 = time.perf_counter()
        mgr.save(b1m, step=2, time=0.0002)
        t_sync = time.perf_counter() - t0
    t_close = time.perf_counter() - t0
    size = os.path.getsize(path)
    print(f"  checkpoint write at {b1m.n}: save_checkpoint {t_save:.4f} s ({size / 1e6:.1f} MB, "
          f"device to host, native write7, sidecar); CheckpointManager.save returned after "
          f"{t_sync:.4f} s (the device-to-host copy), the background write done at "
          f"{t_close:.4f} s [{card}]")
    check(np.array_equal(load_checkpoint(path)[0], b1m.to_numpy().astype(np.float64)),
          "the 1M checkpoint reads back exactly")
    out["checkpoint s"] = t_save

    # 34. adaptive dt
    print(f"[34] adaptive dt (--adaptive-eta), eta sized so the first step is the window "
          f"over 24.5 (100k) and 12.5 (1M) [{card}]")
    eps = float(np.sqrt(0.01))
    amax = float(cuda_accelerations(b.pos, b.mass).norm(dim=1).max())
    t_end, dt_max = float(MAIN_WINDOW[1]), float(f32(float(MAIN_WINDOW[2])))
    eta = (t_end / 24.5) ** 2 * amax / (2 * eps)
    aflags = ["--no-output", "--energy", "--adaptive-eta", repr(eta)]
    res = {}
    for label in ("cuda", "torch"):
        res[label] = counted([csv_small, *MAIN_WINDOW, x, *aflags, "--backend", label])
    taken = {k: int(cli_number(v[0], "Adaptive steps taken:")) for k, v in res.items()}
    drift = {k: cli_number(v[0], "Relative energy drift:") for k, v in res.items()}
    k1_adaptive = res["cuda"][1]
    print(f"  {n_small} all-pairs, eta {eta:.6e}: steps taken K1 {taken['cuda']}, plain "
          f"{taken['torch']}; K1 launches {k1_adaptive} (want {taken['cuda'] + 1}); drift "
          f"{drift['cuda']:.6e} vs {drift['torch']:.6e}; simulate {res['cuda'][4]:.4f} s -> "
          f"{res['cuda'][4] / taken['cuda']:.6f} s/step (plain {res['torch'][4]:.4f} s) [{card}]")
    check(taken["cuda"] == taken["torch"] > STEPS, "adaptive steps equal the plain backend's")
    check(k1_adaptive == taken["cuda"] + 1 and drifts_agree(drift["cuda"], drift["torch"]),
          f"adaptive K1 launches and drift (bound {DRIFT_REL:g} of it + {DRIFT_ABS:g})")
    # the final states, in-process through the same chunk function as the
    # CLI's simulate_adaptive, K1 against the plain force
    force = lambda p, m: cuda_accelerations(p, m, G=1.0, softening_sq=0.01)  # noqa: E731
    plain = lambda p, m: exhaustive_accelerations(p, m, G=1.0, softening_sq=0.01)  # noqa: E731
    b_k1, _, t_dev, (ts, dts) = adaptive_steps(b, 4096, 0.0, t_end, force, eta=eta, eps=eps,
                                               dt_min=0.0, dt_max=dt_max)
    b_pl, _, t_pl, (ts_pl, _) = adaptive_steps(b, 4096, 0.0, t_end, plain, eta=eta, eps=eps,
                                               dt_min=0.0, dt_max=dt_max)
    da = float((force(b.pos, b.mass) - plain(b.pos, b.mass)).abs().max())
    pos_bound = da * t_end * t_end + 2e-6
    dpos = float((b_k1.pos - b_pl.pos).abs().max())
    print(f"  in-process: {ts.shape[0]} steps (plain {ts_pl.shape[0]}), lands at t = "
          f"{float(t_dev)!r} (f32 t_end {float(f32(t_end))!r}), dt {float(dts.min()):.4e}-"
          f"{float(dts.max()):.4e}; final positions K1 against plain max |diff| {dpos:.3e} "
          f"(bound max|da| T^2 + 2e-6 = {pos_bound:.3e}, [30]'s)")
    check(float(t_dev) == float(f32(t_end)) == float(t_pl) and ts.shape[0] == taken["cuda"]
          == ts_pl.shape[0] and bool((dts > 0).all()) and float(dts.max()) <= dt_max,
          "adaptive landing")
    check(dpos < pos_bound, "adaptive final positions, K1 against plain")
    del b_k1, b_pl
    out["K1 adaptive"], out["adaptive s/step 100k"] = k1_adaptive, res["cuda"][4] / taken["cuda"]
    acc1m = bh_fused.barneshut_fused(b1m.pos, b1m.mass)
    amax1m = float(acc1m.norm(dim=1).max())
    t_end1m = float(BH_WINDOW[1])
    eta1m = (t_end1m / 12.5) ** 2 * amax1m / (2 * eps)
    aflags = ["--no-output", "--energy", "--algo", "auto", "--adaptive-eta", repr(eta1m)]
    res = {"persistent": counted([csv1m, *BH_WINDOW, x, *aflags, "--resort-every",
                                  str(RESORT_EVERY)]),
           "one-shot": counted([csv1m, *BH_WINDOW, x, *aflags])}
    taken = {k: int(cli_number(v[0], "Adaptive steps taken:")) for k, v in res.items()}
    drift = {k: cli_number(v[0], "Relative energy drift:") for k, v in res.items()}
    k6_e = res["persistent"][3]
    print(f"  {BH_N} fused, eta {eta1m:.6e}: steps taken persistent {taken['persistent']}, "
          f"one-shot {taken['one-shot']}; K6 {res['persistent'][2]} launches in {k6_e} "
          f"evaluations (want {taken['persistent'] + 1}: prime, a step); drift "
          f"{drift['persistent']:.6e} vs {drift['one-shot']:.6e}; simulate "
          f"{res['persistent'][4]:.4f} s -> {res['persistent'][4] / taken['persistent']:.6f} "
          f"s/step (one-shot {res['one-shot'][4] / taken['one-shot']:.6f}) [{card}]")
    check(taken["persistent"] == taken["one-shot"] > BH_STEPS and k6_e == taken["persistent"] + 1
          and drifts_agree(drift["persistent"], drift["one-shot"]),
          f"persistent adaptive against the one-shot adaptive run (drift bound {DRIFT_REL:g} "
          f"of it + {DRIFT_ABS:g})")
    kw = dict(theta=0.5, softening_sq=0.01, leaf_cap=64)
    st, _ = bp.prime(bp.init_state(b1m.pos, b1m.vel, b1m.mass, G=1.0), **kw)
    _, _, t_dev, (ts, _), _ = bp.kdk_adaptive_steps(
        st, 4096, 0.0, t_end1m, eta=eta1m, eps=eps, dt_min=0.0, dt_max=dt_max, **kw)
    del st
    # the final states, in-process through the CLI's two functions
    # (run_persistent's simulate_persistent_adaptive, simulate_adaptive)
    p_pa, _, taken_pa = bp.simulate_persistent_adaptive(
        b1m.pos, b1m.vel, b1m.mass, 0.0, t_end1m, eta=eta1m, dt_max=float(BH_WINDOW[2]),
        G=1.0, resort_every=RESORT_EVERY, group_size=1024, **kw)
    fused = partial(bh_fused.barneshut_fused, G=1.0, **kw)
    b_os, taken_os = simulate_adaptive(b1m, 0.0, t_end1m, fused, eta=eta1m, softening_sq=0.01,
                                       dt_max=float(BH_WINDOW[2]))
    pos_bound = dmax * t_end1m * t_end1m + 2e-6
    dpos = float((p_pa - b_os.pos).abs().max())
    print(f"  in-process on the layout (no resort): {ts.shape[0]} steps, lands at t = "
          f"{float(t_dev)!r} (f32 t_end {float(f32(t_end1m))!r}); final positions persistent "
          f"({taken_pa} steps) against one-shot ({taken_os}) max |diff| {dpos:.3e} (bound "
          f"{pos_bound:.3e}, [30]'s)")
    check(float(t_dev) == float(f32(t_end1m)), "persistent adaptive landing")
    check(taken_pa == taken_os == taken["persistent"] and dpos < pos_bound,
          "persistent adaptive final positions against the one-shot run")
    del acc1m, p_pa, b_os
    out["K6 persistent adaptive"] = res["persistent"][2]
    out["adaptive s/step 1M"] = res["persistent"][4] / taken["persistent"]

    # 35. merging
    print(f"[35] merging: a cold {n_small}-body clump (random_cloud seed {MERGE_SEED}, v = 0, "
          f"m = 2^-17), --merge-radius {MERGE_RADIUS} --merge-every 5 over {STEPS} steps "
          f"[{card}]")
    arr = random_cloud(n_small, seed=MERGE_SEED)
    arr[:, 3:6] = 0.0
    arr[:, 6] = MERGE_MASS
    csv_m = os.path.join(tmp, "clump.csv")
    _write7(csv_m, arr)
    mflags = ["--merge-radius", repr(MERGE_RADIUS), "--merge-every", "5", "--write-every",
              str(STEPS), "--checkpoint-every", str(STEPS)]
    runs = {"K1": [], "plain": ["--backend", "torch"],
            "persistent": ["--algo", "barnes-hut", "--bh-traversal", "fused",
                           "--resort-every", str(RESORT_EVERY)]}
    merged, states = {}, {}
    for label, extra in runs.items():
        frames_m, ck_m = os.path.join(tmp, f"m_{label}.csv"), os.path.join(tmp, f"m_{label}.ck")
        text, k1_l, k6_l, _, _ = counted([csv_m, *MAIN_WINDOW, frames_m, *mflags,
                                          "--checkpoint", ck_m, *extra])
        merged[label] = int(cli_number(text, "Merged bodies:"))
        states[label] = load_checkpoint(ck_m)[0]
        last = load_frames(frames_m, n_small, frames=2)[-1]
        mass_t = states[label][:, 6]
        mom = (mass_t[:, None] * states[label][:, 3:6]).sum(0)
        scale = float((mass_t[:, None] * np.abs(states[label][:, 3:6])).sum())
        print(f"  {label}: merged {merged[label]}, K1 {k1_l}, K6 {k6_l} launches; mass "
              f"{mass_t.sum()!r} vs {arr[:, 6].sum()!r}; momentum {np.abs(mom).max():.3e} "
              f"(sum m|v| {scale:.3e}); ghosts in the last frame {int((last[:, 4] == 0).sum())}")
        check(mass_t.sum() == arr[:, 6].sum() and int((mass_t == 0).sum()) == merged[label]
              and int((last[:, 4] == 0).sum()) == merged[label],
              f"{label}: mass conserved exactly, ghosts in the mass column")
        # all-pairs forces are antisymmetric to f32 rounding, Barnes-Hut's
        # only to its force error
        bound_p = 1e-3 if label == "persistent" else 1e-5
        check(np.abs(mom).max() <= bound_p * scale + 1e-12,
              f"{label}: momentum within {bound_p:g} of sum m|v|")
        if label == "K1":
            out["K1 merge"] = k1_l
            check(k1_l >= STEPS + 1, "the merge run went through K1")
        if label == "persistent":
            check(k6_l > 0, "the persistent merge run went through K6")
    check(merged["K1"] > 0 and merged["K1"] == merged["plain"] == merged["persistent"],
          f"merged counts {merged}")
    dpos = float(np.abs(states["K1"][:, :3] - states["plain"][:, :3]).max())
    print(f"  final state K1 against plain max |diff| {dpos:.3e} (bound 1e-5)")
    check(dpos < 1e-5, "merge run K1 against plain")
    bm = Bodies.from_numpy(states["K1"], dtype=torch.float32, device=dev)
    bm = bm._replace(mass=torch.as_tensor(arr[:, 6], dtype=torch.float32, device=dev))
    bm = bm._replace(vel=bm.vel + torch.as_tensor(  # a velocity field to carry momentum
        np.random.default_rng(1).uniform(-1, 1, (n_small, 3)), dtype=torch.float32, device=dev))
    _, v_m, m_m, nm = merge_pass(bm.pos, bm.vel, bm.mass, MERGE_RADIUS)
    p0 = (bm.mass.double()[:, None] * bm.vel.double()).sum(0)
    p1 = (m_m.double()[:, None] * v_m.double()).sum(0)
    dp = float((p1 - p0).abs().max())
    scale = float((bm.mass.double()[:, None] * bm.vel.double().abs()).sum())
    merge_ms = cuda_ms(torch, lambda: merge_pass(bm.pos, bm.vel, bm.mass, MERGE_RADIUS), 3)
    print(f"  merge pass at {n_small} on the final positions with the initial masses: {int(nm)} "
          f"merges, mass {float(m_m.double().sum())!r} vs {float(bm.mass.double().sum())!r}, "
          f"momentum change {dp:.3e} (sum m|v| {scale:.3e}, bound 1e-6 of it); "
          f"{merge_ms:.4f} ms [{card}]")
    check(int(nm) > 0 and float(m_m.double().sum()) == float(bm.mass.double().sum())
          and dp <= 1e-6 * scale, "one merge pass conserves mass exactly, momentum to f32 rounding")
    out["merge ms"] = merge_ms

    # 36. block tiers
    n_tiers, eta_b, eps2_b = 3, 0.01, 1e-4
    arr = stratified_cloud(n_big)
    csv_s = os.path.join(tmp, "stratified.csv")
    _write7(csv_s, arr)
    fkw = dict(theta=0.5, softening_sq=eps2_b, leaf_cap=64)
    bs = Bodies.from_numpy(arr, dtype=torch.float32, device=dev)
    st, _ = bp.prime(bp.init_state(bs.pos, bs.vel, bs.mass, G=1.0), **fkw)
    amax_s = float(bp._valid_amax(st.acc, st.valid))
    dt_b = float(f32(np.sqrt(2 * eta_b * np.sqrt(eps2_b) / amax_s) * (1 << (n_tiers - 1)) * 0.9))
    tiers = bp.assign_tiers(st, dt_b, eta=eta_b, eps=float(np.sqrt(eps2_b)), n_tiers=n_tiers)
    occ = (st.gcount > 0).cpu().numpy()
    hist = np.bincount(tiers.cpu().numpy()[occ], minlength=n_tiers)
    order, sizes = bp.tier_order_sizes(tiers, n_tiers)
    print(f"[36] block tiers: stratified_cloud({n_big}) (tools/profile_block.py:43-58), "
          f"--block-tiers {n_tiers} --block-eta {eta_b} --softening2 {eps2_b} --G 1, dt "
          f"{dt_b!r} (the hottest group's need x {1 << (n_tiers - 1)} x 0.9), 8 macro steps, "
          f"--resort-every {RESORT_EVERY}; tier histogram {hist.tolist()} over {int(occ.sum())} "
          f"occupied groups, prefix sizes {sizes} [{card}]")
    check(hist[0] > 0 and hist[-1] > 0, "the tiers split")
    bflags = [csv_s, "0", repr(8.5 * dt_b), repr(dt_b), x, "--no-output", "--algo", "barnes-hut",
              "--bh-traversal", "fused", "--resort-every", str(RESORT_EVERY), "--block-tiers",
              str(n_tiers), "--block-eta", repr(eta_b), "--softening2", repr(eps2_b), "--G", "1",
              "--checkpoint-every", "8"]
    per_macro = {}
    for label, extra in (("masked", []), ("prefix", ["--block-prefix"])):
        ck_s = os.path.join(tmp, f"block_{label}.ck")
        text, _, k6_l, k6_e, wall = counted([*bflags, "--checkpoint", ck_s, *extra])
        check("/persistent" in text, "block tiers took the persistent layout")
        per_macro[label] = (k6_l - 3) / 8  # less the probe's and the prime's
        print(f"  {label}: K6 {k6_l} launches in {k6_e} evaluations, {per_macro[label]:.2f} "
              f"launches a macro step (probe and prime apart); simulate {wall:.4f} s [{card}]")
    same = _same_file(os.path.join(tmp, "block_masked.ck"), os.path.join(tmp, "block_prefix.ck"))
    print(f"  prefix final state bit-identical to masked: {same}")
    check(same, "prefix is bit-identical to masked on the card")
    out["K6 block per macro"] = per_macro

    def copy():
        return st._replace(src=st.src.clone(), vel=st.vel.clone(), acc=st.acc.clone())

    steppers = {
        "masked": lambda: bp.kdk_block_steps(copy(), tiers, 1, dt_b, n_tiers=n_tiers, **fkw),
        "prefix": lambda: bp.kdk_block_prefix_steps(copy(), tiers, order, 1, dt_b, sizes=sizes,
                                                    n_tiers=n_tiers, **fkw),
        "KDK dt": lambda: bp.kdk_steps(copy(), 1, dt_b, **fkw),
        f"KDK dt/{1 << (n_tiers - 1)}": lambda: bp.kdk_steps(
            copy(), 1 << (n_tiers - 1), dt_b / (1 << (n_tiers - 1)), **fkw),
    }
    turns = []
    for label in ("masked", "prefix", "prefix", "masked", "KDK dt",
                  f"KDK dt/{1 << (n_tiers - 1)}"):
        turns.append((label, cuda_ms(torch, steppers[label], 3)))
    print("  ms a macro step in turns: " + ", ".join(f"{k} {v:.4f}" for k, v in turns)
          + f" [{card}]")
    out["block ms"] = turns
    # one sub-step's evaluation where only the finest tier closes, masked
    # (all G slots, the rest gcount 0) and as the prefix order[:sizes[0]],
    # whole (table rebuild + K6) and K6 alone
    idx = torch.as_tensor(order[:sizes[0]], dtype=torch.int64, device=dev)
    masked_gc = torch.where(tiers == n_tiers - 1, st.gcount, 0)
    tree = bp._ft_from_state(st)
    gstart = torch.arange(0, st.src.shape[0], st.group_size, dtype=torch.int32, device=dev)
    k6kw = dict(theta=0.5, eps2=eps2_b, leaf_cap=64, ld=st.ld, group_size=st.group_size)
    parts = {
        "rebuild": lambda: bp._ft_from_state(st),
        "masked whole": lambda: bp.state_forces(st._replace(gcount=masked_gc), **fkw),
        "prefix whole": lambda: bp.subset_state_forces(st, idx, **fkw),
        "masked K6": lambda: bh_fused.fused_group_forces(tree, gstart, masked_gc, st.src,
                                                         st.bsq, **k6kw),
        "prefix K6": lambda: bh_fused.fused_group_forces(tree, gstart[idx], st.gcount[idx],
                                                         st.src, st.bsq, **k6kw),
        "full K6": lambda: bh_fused.fused_group_forces(tree, gstart, st.gcount, st.src,
                                                       st.bsq, **k6kw),
    }
    split = {k: cuda_ms(torch, fn, 5) for k, fn in parts.items()}
    print(f"  a finest-tier sub-step ({int(hist[-1])} closing groups, prefix {sizes[0]} of "
          f"{st.gcount.shape[0]} slots): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f" ms [{card}]")
    out["block split"] = split
    del st, bs
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py needs one GPU",
              file=sys.stderr)
        return 1

    import nbody_tpu_torch

    pkg = os.path.dirname(os.path.abspath(nbody_tpu_torch.__file__))
    check(pkg == os.path.join(ROOT, "nbody_tpu_torch"),
          f"nbody_tpu_torch comes from this checkout (found {pkg})")
    from nbody_tpu_torch.core.types import Bodies
    from nbody_tpu_torch.diag.energy import get_energy
    from nbody_tpu_torch.io.csv import read_bodies
    from nbody_tpu_torch.utils.fixtures import random_cloud, write_fixture
    from nbody_tpu_torch.ops import _cuda, bh_fused
    from nbody_tpu_torch.ops.cuda_exhaustive import (
        cuda_accelerations,
        cuda_potential_energy,
        cuda_rect_accelerations,
        k1_split,
        potential_energy_reference,
        rect_accelerations_reference,
    )

    dev = torch.device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32, "no TF32 in f32 matmuls")

    card, name, sass = build_phase(torch)

    # 2. all-pairs kernel against its twin
    print("[2] all-pairs kernel (nbody_tpu_torch/csrc/allpairs.cu)")
    arr = read_bodies(CSV_100K)
    n = arr.shape[0]
    b = Bodies.from_numpy(arr, dtype=torch.float32, device=dev)
    got = cuda_accelerations(b.pos, b.mass)
    want = rect_accelerations_reference(b.pos, b.pos, b.mass)
    torch.cuda.synchronize()
    k1_err = f32_close(torch, got, want, f"main-path shape {n} x {n}")
    for m_, n_, seed in ((4096, 4096, 1), (100_003, 4_099, 2)):
        c = torch.as_tensor(random_cloud(max(m_, n_), seed), dtype=torch.float32,
                            device=dev)
        pi, pj, mj = c[:m_, :3].contiguous(), c[:n_, :3].contiguous(), c[:n_, 6].contiguous()
        f32_close(torch, cuda_rect_accelerations(pi, pj, mj),
                  rect_accelerations_reference(pi, pj, mj), f"{m_} x {n_}")
    e2 = torch.as_tensor(np.random.default_rng(3).uniform(1e-4, 1e-2, 4096),
                         dtype=torch.float32, device=dev)
    c = torch.as_tensor(random_cloud(4096, 4), dtype=torch.float32, device=dev)
    pb, mb = c[:, :3].contiguous(), c[:, 6].contiguous()
    got_pb = cuda_accelerations(pb, mb, eps2_per_body=e2)
    want_pb = rect_accelerations_reference(pb, pb, mb, eps2_i=e2, eps2_all=e2)
    rel = ((got_pb - want_pb).abs().max() / want_pb.abs().max()).item()
    print(f"  per-body softening 4096 x 4096: max err / scale {rel:.3e} (bound 5e-5)")
    check(rel < 5e-5, "per-body mode")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        out10 = os.path.join(tmp, "ten.csv")
        run_cli([CSV_10, "0", "10", "0.1", out10, "--backend", "cuda"])
        g = np.loadtxt(GOLDEN_10, delimiter=",")
        o = np.loadtxt(out10, delimiter=",")
        gerr = float(np.abs(o - g).max()) if o.shape == g.shape else float("inf")
        # f32 state over 100 steps against the reference binary's f64 %lf
        # output (the plain f32 path measures 4.7e-6 on a CPU)
        print(f"  10-body golden (100 steps, f32 kernel): max |err| {gerr:.3e} "
              "(bound 5e-5)")
        check(gerr < 5e-5, "10-body golden trajectory")

        # 3. potential-energy kernel
        print("[3] potential-energy kernel (nbody_tpu_torch/csrc/potential.cu)")
        pe_k = cuda_potential_energy(b.pos, b.mass).item()
        pe_twin = potential_energy_reference(b.pos, b.mass).item()
        _, pe64 = get_energy(b.pos.double(), b.vel.double(), b.mass.double())
        pe64 = pe64.item()
        k3_err = abs(pe_k - pe_twin)
        print(f"  n={n}: kernel {pe_k!r}, f32 twin {pe_twin!r}, plain fp64 "
              f"{pe64!r}; rel vs fp64 {abs(pe_k - pe64) / abs(pe64):.3e}, rel vs "
              f"twin {k3_err / abs(pe_twin):.3e} (bound 1e-4)")
        check(abs(pe_k - pe64) <= 1e-4 * abs(pe64), "PE vs plain fp64")
        check(k3_err <= 1e-4 * abs(pe_twin), "PE vs twin")
        check(cuda_potential_energy(b.pos, b.mass).item() == pe_k,
              "PE kernel is bit-reproducible")
        c = torch.as_tensor(random_cloud(5_003, seed=5), dtype=torch.float32, device=dev)
        pe_check(cuda_potential_energy,
                 {"f32 twin": potential_energy_reference,
                  "plain fp64 PE": lambda p, m: potential_energy_reference(p.double(),
                                                                           m.double())},
                 c[:, :3].contiguous(), c[:, 6].contiguous(), 1e-4, "K3")

        # 4. the main path
        print("[4] main path: 100k bodies x 10 KDK steps, f32, --energy")
        out_k = os.path.join(tmp, "cuda.csv")
        argv = [CSV_100K, *MAIN_WINDOW, out_k, "--energy"]
        cuda_rect_accelerations.launches = 0
        cuda_potential_energy.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text_k = run_cli(argv)
        torch.cuda.synchronize()
        wall_k = time.perf_counter() - t0
        k1_launches = cuda_rect_accelerations.launches
        k3_launches = cuda_potential_energy.launches
        print(f"  launches: all-pairs {k1_launches} (want {STEPS + 1}), "
              f"potential {k3_launches} (want 2)")
        check(k1_launches == STEPS + 1, "all-pairs launches on the main path")
        check(k3_launches == 2, "potential launches on the main path")
        check("backend: cuda, dtype: f32" in text_k, "main path took the kernel")
        frames_k = load_frames(out_k, n)

        # 5. cross-check against the plain backend on the card
        print("[5] cross-check: the same run with --backend torch")
        out_t = os.path.join(tmp, "torch.csv")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text_t = run_cli([CSV_100K, *MAIN_WINDOW, out_t, "--energy",
                          "--backend", "torch"])
        torch.cuda.synchronize()
        wall_t = time.perf_counter() - t0
        check(cuda_rect_accelerations.launches == k1_launches
              and cuda_potential_energy.launches == k3_launches,
              "the plain backend launched no kernel")
        frames_t = load_frames(out_t, n)
        dpos = float(np.abs(frames_k[-1, :, 1:4] - frames_t[-1, :, 1:4]).max())
        drift_k = cli_number(text_k, "Relative energy drift:")
        drift_t = cli_number(text_t, "Relative energy drift:")
        # frames are %lf-printed (1e-6 resolution); f32 sums in two orders
        print(f"  final positions max |diff| {dpos:.3e} (bound 1e-5); drift "
              f"kernel {drift_k:.3e} vs plain {drift_t:.3e}, |diff| "
              f"{abs(drift_k - drift_t):.3e} (bound 1e-3)")
        check(dpos < 1e-5, "final positions agree")
        check(abs(drift_k - drift_t) < 1e-3, "energy drifts agree")

        # 6. timing
        print(f"[6] timing on {card}")
        k1_ms = cuda_ms(torch, lambda: cuda_accelerations(b.pos, b.mass), 10)
        k1_plain_ms = cuda_ms(
            torch, lambda: rect_accelerations_reference(b.pos, b.pos, b.mass), 2)
        k3_ms = cuda_ms(torch, lambda: cuda_potential_energy(b.pos, b.mass), 10)
        k3_plain_ms = cuda_ms(
            torch, lambda: potential_energy_reference(b.pos, b.mass), 2)
        pairs = float(n) ** 2
        print(f"  all-pairs {n}x{n}: kernel {k1_ms:.4f} ms "
              f"({pairs / k1_ms / 1e-3:.4e} pairs/s), plain {k1_plain_ms:.4f} ms "
              f"[{card}]")
        clocks = "; ".join(clock_and_power(torch, lambda: cuda_accelerations(b.pos, b.mass)))
        print(f"  SM clock and power draw while K1 runs at {n}x{n}: {clocks} [{card}]")
        # K1 at every number of source slices a block, each held against the
        # plain version, on the main path's square and the ragged and robust
        # rectangles, beside its time before the redesign, its bound and its
        # fp32 issue floor (SASS fp32 instructions a pair, [1])
        sms = _cuda.sm_count(dev)
        k1_sass = sass_of(sass, "allpairs_kernelILb0")
        arr1m = random_cloud(BH_N, seed=0)
        c = torch.as_tensor(arr1m, dtype=torch.float32, device=dev)
        k1_shapes = {(n, n): (b.pos, b.pos, b.mass)}
        for m_, n_ in ((100_003, 4_099), (BH_N, 1_953)):
            k1_shapes[m_, n_] = (c[:m_, :3].contiguous(), c[:n_, :3].contiguous(),
                                 c[:n_, 6].contiguous())
        for (m_, n_), r in k1_shapes.items():
            want_r = rect_accelerations_reference(*r)
            split_ms = {}
            for split in (1, 2, 4, 8):
                got_r = cuda_rect_accelerations(*r, _split=split)
                f32_close(torch, got_r, want_r, f"K1 {m_} x {n_}, {split} source slices")
                check(torch.equal(cuda_rect_accelerations(*r, _split=split), got_r),
                      "K1 reruns are bit-identical")
                split_ms[split] = cuda_ms(
                    torch, lambda: cuda_rect_accelerations(*r, _split=split), 10)
            ms = k1_ms if m_ == n else cuda_ms(torch, lambda: cuda_rect_accelerations(*r), 10)
            before = BEFORE_MS[f"K1 {m_}x{n_}"]
            kb = bound((m_ * 3 + n_ * 4 + m_ * 3) * 4, float(m_) * n_ * FORCE_OPS, FP32_PEAK)
            floor = ("not measured" if k1_sass is None else
                     f"{issue_floor_ms(fp32_per_rsq(k1_sass), float(m_) * n_, 128, sms):.4f}"
                     f" ms ({fp32_per_rsq(k1_sass):.2f} fp32 instructions a pair)")
            print(f"  K1 {m_}x{n_}: kernel {ms:.4f} ms at its pick of "
                  f"{k1_split(m_, sms)} source slices (before the redesign {before} ms, "
                  f"{ms / before:.3f}x); 1/2/4/8 slices "
                  + " / ".join(f"{split_ms[k]:.4f}" for k in (1, 2, 4, 8))
                  + f" ms; bound {kb[0]:.4f} ms ({kb[1]}); fp32 issue floor {floor} "
                  f"({sms} SMs x 128 lanes at {CLOCK_HZ / 1e6:.0f} MHz) [{card}]")
        # K3 at 100k and 1M beside its time before the redesign, its bound on
        # the unordered pairs, its fp32 issue floor (SASS fp32 instructions a
        # MUFU.RSQ, [1]) and MUFU floor, and its plain version's time; at 1M
        # against its twin and the plain fp64 PE of the cloud (one run each;
        # [18] holds K5 against the latter, on the same fp64 bodies)
        p1m, m1m = c[:, :3].contiguous(), c[:, 6].contiguous()
        k3_1m = cuda_potential_energy(p1m, m1m).item()
        twin_1m, twin_1m_ms = timed_once(
            torch, lambda: potential_energy_reference(p1m, m1m, chunk=128).item())
        c64 = torch.as_tensor(arr1m, dtype=torch.float64, device=dev)
        pe64_1m = timed_once(torch, lambda: potential_energy_reference(
            c64[:, :3].contiguous(), c64[:, 6].contiguous(), chunk=128).item())
        del c64
        for label, want in (("f32 twin", twin_1m), ("plain fp64 PE", pe64_1m[0])):
            rel = abs(k3_1m - want) / abs(want)
            print(f"  K3 {BH_N}: kernel {k3_1m!r}, {label} {want!r}, rel {rel:.3e} "
                  "(bound 1e-4)")
            check(rel <= 1e-4, f"K3 at {BH_N} against the {label}")
        k3_1m_ms = cuda_ms(torch, lambda: cuda_potential_energy(p1m, m1m), 3)
        k3_sass = sass_of(sass, "PeF32")
        for nn, ms, plain in ((n, k3_ms, f"{k3_plain_ms:.4f} ms"),
                              (BH_N, k3_1m_ms, f"{twin_1m_ms:.1f} ms (one run)")):
            pairs_u = nn * (nn - 1) / 2
            floor = ("fp32 issue floor not measured" if k3_sass is None else
                     f"fp32 issue floor {issue_floor_ms(fp32_per_rsq(k3_sass), pairs_u, 128, sms):.4f}"
                     f" ms ({fp32_per_rsq(k3_sass):.2f} fp32 instructions a pair)")
            floor += (f", MUFU floor {issue_floor_ms(1, pairs_u, MUFU_LANES, sms):.4f} ms "
                      f"({sms} SMs at {CLOCK_HZ / 1e6:.0f} MHz)")
            pe_report("K3", nn, ms, plain, floor, 4, FP32_PEAK, card)
        del c, k1_shapes, want_r, got_r, p1m, m1m
        main_pairs = (STEPS + 1) * pairs
        for label, text, wall in (("cuda", text_k, wall_k), ("torch", text_t, wall_t)):
            print(f"  main path --backend {label}: simulate "
                  f"{cli_number(text, 'Elapsed wall time:'):.4f} s incl. frame "
                  f"writing -> {cli_number(text, 'Pair interactions/sec:'):.4e} "
                  f"pairs/s; whole CLI call {wall:.4f} s [{card}]")
        # compute only, in turns: plain, kernel, kernel, plain
        for label in ("torch", "cuda", "cuda", "torch"):
            text = run_cli([CSV_100K, *MAIN_WINDOW, os.path.join(tmp, "x.csv"),
                            "--no-output", "--backend", label])
            sim = cli_number(text, "Elapsed wall time:")
            print(f"  --no-output --backend {label}: {sim:.4f} s -> "
                  f"{main_pairs / sim:.4e} pairs/s [{card}]")

        # 7. fused Barnes-Hut kernel against its twin, at 100k and at the
        # main path's 1M
        print("[7] fused Barnes-Hut kernel (nbody_tpu_torch/csrc/bh_fused.cu)")
        b1m = Bodies.from_numpy(arr1m, dtype=torch.float32, device=dev)
        k6 = {}  # n -> (kernel arguments, keywords, max |err|)
        for bodies in (b, b1m):
            fi = bh_fused.prepare_fused(bodies.pos, bodies.mass)
            kw = dict(theta=0.5, eps2=0.01, leaf_cap=64, ld=fi.ld,
                      group_size=fi.group_size)
            args = (fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq)
            got_s, stats_k = bh_fused.fused_group_forces(*args, **kw)
            want_s, stats_p = bh_fused.fused_group_forces_reference(*args, **kw)
            torch.cuda.synchronize()
            err = f32_close(torch, got_s, want_s, f"n={bodies.n}, ld {fi.ld}, "
                            f"{fi.gstart.shape[0]} group slots, B {fi.group_size}")
            k6[bodies.n] = (args, kw, err, stats_k)
            lanes = {name: int(stats_k[:, lane].long().sum())
                     for name, lane in (("pops", bh_fused.S_POPS),
                                        ("near_bodies", bh_fused.S_NEAR),
                                        ("far_children", bh_fused.S_FAR))}
            lanes["frontier_overflow"] = int(stats_k[:, bh_fused.S_OVF].max())
            print(f"  stats {lanes}; equal to the twin's lane by lane: "
                  f"{bool(torch.equal(stats_k, stats_p))}")
            check(torch.equal(stats_k, stats_p), "K6 stats equal the twin's")
            check(lanes["far_children"] > 0 and lanes["frontier_overflow"] == 0,
                  "K6 accepted far cells without overflow")
            again_s, again_stats = bh_fused.fused_group_forces(*args, **kw)
            check(torch.equal(again_s, got_s) and torch.equal(again_stats, stats_k),
                  "K6 reruns are bit-identical")
            print("  two kernel runs bit-identical: True")

        # 8. the whole fused call against exact forces at 1M
        print(f"[8] barneshut_fused against exact all-pairs forces, {BH_N} "
              "bodies (random_cloud seed 0)")
        acc_bh = bh_fused.barneshut_fused(b1m.pos, b1m.mass)
        exact = cuda_accelerations(b1m.pos, b1m.mass)
        torch.cuda.synchronize()
        dacc = (acc_bh - exact).norm(dim=1)
        dmax = (acc_bh - exact).abs().max().item()
        rel = dmax / exact.abs().max().item()
        med = (dacc / exact.norm(dim=1)).median().item()
        print(f"  max |a - exact| / max |a| = {rel:.4e} (bound {BH_BOUND}); "
              f"median |a - exact| / |exact| = {med:.4e}; max |a - exact| "
              f"{dmax:.4e}")
        check(rel < BH_BOUND and bool(torch.isfinite(acc_bh).all()),
              "Barnes-Hut within 0.02 of exact forces at 1M")

        # 9. the Barnes-Hut main path
        print(f"[9] Barnes-Hut main path: {BH_N} bodies x {BH_STEPS} KDK steps, "
              "--algo auto, f32, --energy, --write-every 5")
        csv1m = os.path.join(tmp, "bh_1m.csv")
        t0 = time.perf_counter()
        write_fixture(csv1m, arr1m)
        print(f"  wrote {csv1m} in {time.perf_counter() - t0:.2f} s")
        out_bh = os.path.join(tmp, "bh.csv")
        bh_argv = [csv1m, *BH_WINDOW, out_bh, "--energy", "--write-every", "5"]
        cuda_rect_accelerations.launches = 0
        cuda_potential_energy.launches = 0
        bh_fused.fused_group_forces.launches = 0
        bh_fused.fused_group_forces.evaluations = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text_bh = run_cli([*bh_argv, "--algo", "auto"])
        torch.cuda.synchronize()
        wall_bh = time.perf_counter() - t0
        k6_launches = bh_fused.fused_group_forces.launches
        k6_evals = bh_fused.fused_group_forces.evaluations
        k3_bh = cuda_potential_energy.launches
        k1_bh = cuda_rect_accelerations.launches
        print(f"  launches: fused Barnes-Hut {k6_launches} in {k6_evals} evaluations (want "
              f"{BH_STEPS + 1}, two launches each, and the probe's pricing launch), "
              f"potential {k3_bh} (want 2), all-pairs {k1_bh} (want 0); whole CLI call "
              f"{wall_bh:.4f} s")
        check("Algorithm: barnes-hut, backend: cuda/fused" in text_bh,
              "--algo auto took the fused Barnes-Hut kernel")
        check(k6_evals == BH_STEPS + 1 and k6_launches == 2 * k6_evals + 1,
              "fused Barnes-Hut evaluations and launches")
        check(k3_bh == 2 and k1_bh == 0, "potential / all-pairs launches")
        frames_bh = load_frames(out_bh, BH_N, frames=2)

        # 10. cross-check against the exhaustive run (K1)
        print("[10] cross-check: the same run with --algo exhaustive")
        out_ex = os.path.join(tmp, "ex.csv")
        text_ex = run_cli([*bh_argv[:4], out_ex, *bh_argv[5:], "--algo",
                           "exhaustive"])
        frames_ex = load_frames(out_ex, BH_N, frames=2)
        dpos_bh = float(np.abs(frames_bh[-1, :, 1:4] - frames_ex[-1, :, 1:4]).max())
        drift_bh = cli_number(text_bh, "Relative energy drift:")
        drift_ex = cli_number(text_ex, "Relative energy drift:")
        # Over T = 5 dt a force difference da moves a body by 0.5 da T^2;
        # allow twice that for [8]'s largest da (the difference grows as the
        # states part) plus the 1e-6 %lf resolution of the two files.
        t_bh = BH_STEPS * BH_DT
        pos_bound = dmax * t_bh * t_bh + 2e-6
        print(f"  final positions max |diff| {dpos_bh:.3e} (bound "
              f"max|da| T^2 + 2e-6 = {pos_bound:.3e}); drift Barnes-Hut "
              f"{drift_bh:.3e} vs exhaustive {drift_ex:.3e}, |diff| "
              f"{abs(drift_bh - drift_ex):.3e} (bound 1e-3)")
        check(dpos_bh < pos_bound, "final positions agree")
        check(abs(drift_bh - drift_ex) < 1e-3, "energy drifts agree")

        # 11. Barnes-Hut timing
        print(f"[11] Barnes-Hut timing on {card}")
        (args100k, kw100k, _, _), (args1m, kw1m, _, stats1m) = k6[n], k6[BH_N]
        k6_ms_100k = cuda_ms(torch, lambda: bh_fused.fused_group_forces(
            *args100k, **kw100k), 10)
        kw_k = dict(kw100k, frontier_cap=bh_fused.FRONTIER_CAP)
        pricing_100k = cuda_ms(torch, lambda: bh_fused.kernel_forces(
            torch.float32, *args100k, **kw_k, debug_mode="pops"), 10)
        order100k = bh_fused.heavy_first(k6[n][3], args100k[2])
        ordered_100k = cuda_ms(torch, lambda: bh_fused.kernel_forces(
            torch.float32, *args100k, **kw_k, order=order100k), 10)
        k6_plain_ms_100k = cuda_ms(torch, lambda: bh_fused.fused_group_forces_reference(
            *args100k, **kw100k), 2)
        k6_ms = cuda_ms(torch, lambda: bh_fused.fused_group_forces(*args1m, **kw1m), 10)
        k6_plain_ms = cuda_ms(torch, lambda: bh_fused.fused_group_forces_reference(
            *args1m, **kw1m), 1)
        acc1m_s, _ = bh_fused.fused_group_forces(*args1m, **kw1m)
        perm1m = bh_fused.prepare_fused(b1m.pos, b1m.mass).perm
        prep_ms = cuda_ms(torch, lambda: bh_fused.prepare_fused(b1m.pos, b1m.mass), 10)
        scatter_ms = cuda_ms(torch, lambda: bh_fused.scatter_back(acc1m_s, perm1m), 10)
        whole_ms = cuda_ms(torch, lambda: bh_fused.barneshut_fused(b1m.pos, b1m.mass), 10)
        print(f"  K6 at {n}: kernel {k6_ms_100k:.4f} ms (timed apart: the pricing pass "
              f"{pricing_100k:.4f} ms, the ordered full kernel {ordered_100k:.4f} ms), plain "
              f"{k6_plain_ms_100k:.4f} ms [{card}]")
        print(f"  K6 at {BH_N} (ld {kw1m['ld']}, {args1m[1].shape[0]} group slots): "
              f"kernel {k6_ms:.4f} ms, plain {k6_plain_ms:.4f} ms (one run) [{card}]")
        print(f"  barneshut_fused at {BH_N}: whole {whole_ms:.4f} ms = sort+build+"
              f"groups {prep_ms:.4f} ms + K6 {k6_ms:.4f} ms + scatter "
              f"{scatter_ms:.4f} ms (parts timed apart) [{card}]")
        for algo in ("barnes-hut", "exhaustive", "barnes-hut"):
            text = run_cli([csv1m, *BH_WINDOW, os.path.join(tmp, "x.csv"),
                            "--no-output", "--algo", algo])
            sim = cli_number(text, "Elapsed wall time:")
            print(f"  {BH_N} --no-output --algo {algo}: simulate {sim:.4f} s "
                  f"({BH_STEPS + 1} evaluations) -> {sim / BH_STEPS:.4f} s/step "
                  f"[{card}]")

        fp64_kernels = fp64_phases(torch, dev, card, sass, arr, arr1m, csv1m, tmp, drift_bh,
                                   pe64_1m)
        list_kernels = list_phases(torch, dev, card, sass, arr, arr1m, csv1m, tmp, exact,
                                   frames_ex, drift_ex, drift_bh)
        del exact
        k2_entry, robust_df = robust_phases(torch, dev, card, sass, arr, got, tmp, csv1m)
        fp64_kernels[-1].update(robust_df)
        k6_entry = stage_phase(torch, dev, card, b, pairs / k1_ms * 1e3)
        persistent_launches = persistent_phases(
            torch, dev, card, b1m, csv1m, tmp, frames_bh, drift_bh, dmax,
            {"whole": whole_ms, "set-up": prep_ms, "K6": k6_ms, "scatter": scatter_ms})
        options = option_phases(torch, dev, card, b, b1m, csv1m, tmp, frames_bh, dmax)

    small = (2 * n * 3 + n + n * 3) * 4  # pos_i, pos_j, mass, out (f32)
    k1_bound = bound(small, pairs * FORCE_OPS, FP32_PEAK)
    k3_bound = pe_bound(n, 4, FP32_PEAK)
    print(json.dumps({"kernels": [
        {"name": "allpairs_f32", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/allpairs.cu",
         "replaces": "nbody_tpu/ops/pallas_exhaustive.py:64",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None,
         "launches_robust_persistent": persistent_launches["K1 robust persistent"],
         "launches_resume": options["K1 resume"], "launches_adaptive": options["K1 adaptive"],
         "launches_merge": options["K1 merge"]},
        k2_entry,
        {"name": "potential_f32", "route": "cuda",
         "source": "nbody_tpu_torch/csrc/potential.cu",
         "replaces": "nbody_tpu/diag/energy.py:27",
         "launches": k3_launches, "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": None},
        {**k6_entry, "launches": k6_launches, "evaluations": k6_evals,
         "launches_persistent": persistent_launches["K6 persistent"],
         "launches_robust_persistent": persistent_launches["K6 robust persistent"],
         "launches_persistent_adaptive": options["K6 persistent adaptive"],
         "launches_per_macro_step_block_masked": options["K6 block per macro"]["masked"],
         "launches_per_macro_step_block_prefix": options["K6 block per macro"]["prefix"]},
        *fp64_kernels,
        *list_kernels,
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
