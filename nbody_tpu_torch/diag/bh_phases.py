"""Per-phase Barnes-Hut timing breakdown — counterpart of
``nbody_tpu/diag/bh_phases.py``, the analog of the reference's
-DPRINT_KERNEL_TIME per-kernel timers (cuda/barnes-hut.cu:938-948,
1040-1049).

One evaluation runs as its phases, the same functions in the same order
with nothing between them, and the boundaries are marked: with CUDA
events on the card (the device's timeline, so a phase's share includes
the gaps in which the device waits for that phase's launches), with the
host clock on the CPU.  The whole call is marked the same way, before and
after, right after each split run; of `reps` such pairs (default 10) the
report gives the pair whose phases' sum over its whole call is the
median, and that ratio.  The JAX package fences each phase on its own
instead; on the card that charges every phase its own launches, without
the overlap of one phase's launches with the previous phase's device
work.

Used by ``nbody_tpu_torch --timers`` (one report before the run).
"""

from __future__ import annotations

import gc

import torch

from nbody_tpu_torch.diag.timing import mark, seconds


def _marked(fns, device: torch.device) -> list:
    """Seconds of each of `fns`, run in order with a mark between each two,
    from an idle device to the last one's end."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks = [mark(device)]
    for fn in fns:
        fn()
        marks.append(mark(device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return [seconds(a, b) for a, b in zip(marks, marks[1:])]


def _split(stages, whole, device: torch.device, reps: int) -> dict:
    """{name: seconds} of the stages (name, fn) of one marked evaluation,
    and "TOTAL (one call)" of one whole call `whole` run right after it:
    of `reps` such adjacent pairs (after a warm-up pair, with the garbage
    collector off, as ``timeit`` runs), the pair whose ratio of the two is
    the median, so a drift of the host's speed over the runs cancels."""
    pairs = []
    was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        for _ in range(reps + 1):
            times = _marked([fn for _, fn in stages], device)
            pairs.append((times, _marked([whole], device)[0]))
    finally:
        if was_enabled:
            gc.enable()
    pairs = sorted(pairs[1:], key=lambda p: sum(p[0]) / p[1])
    times, whole_s = pairs[len(pairs) // 2]
    out = dict(zip((name for name, _ in stages), times))
    out["TOTAL (one call)"] = whole_s
    return out


def fused_phase_times(pos, mass, *, G, softening_sq, theta, group_size=1024, leaf_cap=64,
                      reps=10, group_forces=None) -> dict:
    """Phase seconds of the fused path (``bh_fused.barneshut_fused``):
    sort, grid, group, kernel (K6's wrapper: its pricing pass and the
    heaviest-first launch; or `group_forces`, its plain version), scatter,
    and the whole call."""
    from nbody_tpu_torch.ops import bh_fused as bf
    from nbody_tpu_torch.ops.bh_grid import build_grid

    group_forces = group_forces or bf.fused_group_forces
    ld = bf.auto_ld(pos.shape[0])
    x = {}

    def sort():
        x["perm"], x["pos"], x["gm"], x["keys"], x["border"] = bf.sort_bodies(pos, mass, G=G)

    def grid():
        x["tree"] = build_grid(x["pos"], x["gm"], x["keys"], bf.MORTON_DEPTH, ld)

    def group():
        x["groups"] = bf.group_inputs(x["pos"], x["gm"], x["keys"], x["border"], ld=ld,
                                      group_size=group_size)

    def kernel():
        gstart, gcount, src, bsq, _ = x["groups"]
        x["acc"], _ = group_forces(x["tree"], gstart, gcount, src, bsq, theta=theta,
                                   eps2=softening_sq, leaf_cap=leaf_cap, ld=ld,
                                   group_size=group_size)

    def scatter():
        bf.scatter_back(x["acc"], x["perm"])

    def whole():
        bf.barneshut_fused(pos, mass, G=G, softening_sq=softening_sq, theta=theta,
                           group_size=group_size, leaf_cap=leaf_cap, group_forces=group_forces)

    return _split([("sort", sort), ("grid", grid), ("group", group), ("kernel", kernel),
                   ("scatter", scatter)], whole, pos.device, reps)


def flat_phase_times(pos, mass, *, G, softening_sq, theta, reps=10, group_forces=None,
                     **bh_kw) -> dict:
    """Phase seconds of the list path (``barneshut.barneshut_accelerations``
    with the flat traversal): sort+build+group, traverse, eval (K7's
    wrapper for pos's dtype, or `group_forces`), scatter, and the whole
    call.  `bh_kw` are its group_size, leaf_cap, depth and list_size."""
    from nbody_tpu_torch.ops import barneshut as bh

    group_forces = group_forces or bh.default_group_forces(pos.dtype)
    list_size = bh_kw.get("list_size", 16384)
    group_size, split_level, leaf_cap, depth = bh.list_layout(
        pos.shape[0], bh_kw.get("depth", 9), bh_kw.get("group_size", 0),
        bh_kw.get("leaf_cap", 0))
    x = {}

    def prepare():
        x["prep"] = bh._prepare(pos, mass, depth, group_size, split_level)

    def traverse():
        _, _, levels, border, pos_s, mass_s, _, _, _, lo, hi = x["prep"]
        x["lists"], x["lengths"], _ = bh.traverse_groups(
            levels, border, pos_s, mass_s * G, lo, hi, G=G, theta=theta, leaf_cap=leaf_cap,
            frontier_size=1024, range_size=1024, list_size=list_size, traversal="flat")

    def evaluate():
        x["acc"] = group_forces(x["prep"][8], x["lists"], x["lengths"], eps2=softening_sq)

    def scatter():
        _, perm, _, _, _, _, group_idx, group_valid, _, _, _ = x["prep"]
        bh.scatter_groups(x["acc"].to(pos.dtype), group_idx, group_valid, perm)

    def whole():
        bh.barneshut_accelerations(pos, mass, G=G, softening_sq=softening_sq, theta=theta,
                                   traversal="flat", group_forces=group_forces, **bh_kw)

    return _split([("sort+build+group", prepare), ("traverse", traverse),
                   ("eval", evaluate), ("scatter", scatter)], whole, pos.device, reps)


def report(times: dict) -> str:
    """One line a phase, in ms, the sum of the phases against the whole
    call last."""
    width = max(len(k) for k in times)
    lines = [f"  {k:<{width}}  {v * 1e3:10.3f} ms" for k, v in times.items()]
    total = [v for k, v in times.items() if k.startswith("TOTAL")]
    if total and total[0] > 0:
        parts = sum(v for k, v in times.items() if not k.startswith("TOTAL"))
        lines.append(f"  {'phases / total':<{width}}  {parts / total[0]:10.3f}")
    return "\n".join(lines)
