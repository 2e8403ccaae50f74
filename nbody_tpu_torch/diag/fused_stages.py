"""K6's stage cuts timed on the card — the twin of
``tools/profile_fused_stages.py``.

    python -m nbody_tpu_torch.diag.fused_stages [N] [--split-stage] [--robust] [--ld L]

Runs the real f32 kernel (``csrc/bh_fused.cu``) at each stage cut of
``bh_fused.CUTS`` over the same tables and groups: "none" (the launch
only), "pops" (+ traversal and classification), "stage" (+ far and near
staging), "dma" (+ the near rows loaded into shared memory), "full" (+ the
evaluation, production); with ``--split-stage`` "pops", "stagefar",
"stagenear" and "stage", which price the two staging branches apart.
Each cut is timed with CUDA events, the best of 5 after a warm-up, each
call queued behind a spin kernel so that the events time the card's work
and not the host's Python around the launch; the increments between cuts
price one mechanism each.  The set-up (sort, grid, groups) is outside
every cut, unlike the JAX tool's "none".  The cuts take the group slots
heaviest first, as the wrapper does; its pricing pass (one "pops" launch
in slot order) is timed apart, and so is the whole wrapper.

N bodies (default 1M) of the uniform cloud ``random_cloud(N, seed=0)``,
or with ``--robust`` the robust hybrid's input: ``plummer_cloud(N)`` with
8 escapers (``with_escapers``), the robust box (``robust_box``), the
outliers zero-massed, at the depth the pricer picks
(``bh_autold.choose_ld``) unless ``--ld`` gives one.  It runs on the card
only: with no card it exits 1 and says why.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from nbody_tpu_torch.core import constants
from nbody_tpu_torch.ops import bh_autold, bh_fused
from nbody_tpu_torch.utils.fixtures import plummer_cloud, random_cloud, with_escapers

MODES = ("none", "pops", "stage", "dma", "full")
SPLIT_MODES = ("pops", "stagefar", "stagenear", "stage")
LEAF_CAP = 64
SPIN_CYCLES = 10_000_000  # ~5 ms of the card's clock, ahead of each timed call


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def uniform_inputs(n: int, device, seed: int = 0):
    """(K6 arguments, keywords) of one f32 evaluation of
    ``random_cloud(n, seed)``, as ``barneshut_fused`` makes them."""
    arr = random_cloud(n, seed=seed)
    pos = torch.as_tensor(arr[:, :3], dtype=torch.float32, device=device)
    mass = torch.as_tensor(arr[:, 6], dtype=torch.float32, device=device)
    return k6_args(bh_fused.prepare_fused(pos, mass))


def robust_inputs(n: int, device, seed: int = 0, ld: int = 0):
    """(K6 arguments, keywords) of the tree half of one robust f32
    evaluation of ``with_escapers(plummer_cloud(n, seed))``, as
    ``barneshut_fused_robust`` makes them, at depth `ld` or the pricer's."""
    arr = with_escapers(plummer_cloud(n, seed=seed))
    if not ld:
        ld, _ = bh_autold.choose_ld(arr[:, :3], arr[:, 6], robust=True, leaf_cap=LEAF_CAP)
    pos = torch.as_tensor(arr[:, :3], dtype=torch.float32, device=device)
    mass = torch.as_tensor(arr[:, 6], dtype=torch.float32, device=device)
    center, border, out_idx = bh_fused.robust_box(pos)
    fi = bh_fused.prepare_fused(pos - center, mass.index_fill(0, out_idx, 0.0), ld=ld,
                                border=border)
    return k6_args(fi)


def k6_args(fi: bh_fused.FusedInputs):
    """(K6 arguments, keywords) of `fi` at the fused path's defaults."""
    kw = dict(theta=constants.THETA, eps2=constants.SOFTENING_SQ, leaf_cap=LEAF_CAP,
              ld=fi.ld, group_size=fi.group_size, frontier_cap=bh_fused.FRONTIER_CAP)
    return (fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq), kw


def best_ms(fn, reps: int = 5) -> float:
    """Best device ms of `reps` calls of `fn`, after one warm-up call, each
    timed with CUDA events.  Each call is queued behind a spin kernel, so
    the host has enqueued all of it before the card reaches the start
    event: the events time the card's work, also where the host takes
    longer to launch it than the card to run it (the short cuts)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def profile(args, kw, modes=MODES, order=None) -> dict[str, float]:
    """{cut: best ms} over `modes`, in order, of K6 f32 taking the group
    slots in `order` (None: slot order)."""
    return {mode: best_ms(lambda: bh_fused.kernel_forces(
        torch.float32, *args, **kw, debug_mode=mode, order=order)) for mode in modes}


def report(times: dict[str, float], label: str) -> str:
    """One line per cut: its ms and the increment over the cut before."""
    lines, prev = [label], None
    for mode, ms in times.items():
        delta = "" if prev is None else f"  ({ms - prev:+.4f} ms)"
        lines.append(f"  {mode:>9}: {ms:9.4f} ms{delta}")
        prev = ms
    return "\n".join(lines)


def pair_counts(stats: torch.Tensor, gcount: torch.Tensor, group_size: int):
    """(real pairs, issued pairs of live warps, issued pairs of whole
    blocks) of one f32 K6 call from its stats lanes: real = sum of staged
    sources x group count; a warp holds 64 body slots (two a thread) and
    one past the group's count skips the evaluation; a block holds the
    warps of `group_size` bodies."""
    src = stats[:, bh_fused.S_SRC].double()
    gc = gcount.double()
    warp_slots = torch.ceil(gc / 64.0) * 64.0
    block = 64 * -(-group_size // 64)
    return (float((src * gc).sum()), float((src * warp_slots).sum()),
            float((src * block).sum()))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("--split-stage", action="store_true",
                    help="price the far and near staging branches apart")
    ap.add_argument("--robust", action="store_true",
                    help="the robust hybrid's escaper input and box")
    ap.add_argument("--ld", type=int, default=0, help="grid depth (default: the pricer's)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device; the stage profiler times the kernel on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if a.robust:
        args, kw = robust_inputs(a.n, dev, ld=a.ld)
        label = f"with_escapers(plummer_cloud({a.n})), robust box"
    else:
        args, kw = uniform_inputs(a.n, dev)
        label = f"random_cloud({a.n}, seed=0)"
    _, stats = bh_fused.kernel_forces(torch.float32, *args, **kw)
    real, warp_issued, block_issued = pair_counts(stats, args[2], kw["group_size"])
    order = bh_fused.heavy_first(stats, args[2])
    card = card_line()
    print(f"{label}: ld {kw['ld']}, {args[1].shape[0]} group slots; staged sources "
          f"{int(stats[:, bh_fused.S_SRC].long().sum())}, near bodies "
          f"{int(stats[:, bh_fused.S_NEAR].long().sum())}, pops "
          f"{int(stats[:, bh_fused.S_POPS].long().sum())}; real pairs {real:.4e}, "
          f"source-weighted lane fill {real / block_issued:.4f} of whole blocks, "
          f"{real / warp_issued:.4f} of live warps [{card}]")
    modes = SPLIT_MODES if a.split_stage else MODES
    print(report(profile(args, kw, modes, order), f"heavy-first order [{card}]"))
    pricing = best_ms(lambda: bh_fused.kernel_forces(torch.float32, *args, **kw,
                                                     debug_mode="pops"))
    wrapper = best_ms(lambda: bh_fused.fused_group_forces(*args, **kw))
    print(f"the pricing pass (pops, slot order) {pricing:.4f} ms; the wrapper (pricing "
          f"pass, order, full kernel) {wrapper:.4f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
