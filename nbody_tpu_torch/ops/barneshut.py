"""Morton body groups and the Barnes-Hut error types — the subset of
``nbody_tpu/ops/barneshut.py`` that the fused path needs
(``group_bodies``, ``compact_groups``, ``CapacityError``,
``ResolutionError``).

The list-based traversal and its evaluator (K7) are not ported yet.
"""

from __future__ import annotations

import torch


class CapacityError(RuntimeError):
    """Static traversal capacities exceeded — results would drop sources.
    The analog of the reference's node-pool exhaustion abort
    (openmp/barnes-hut.c:158-160)."""


class ResolutionError(RuntimeError):
    """A cluster denser than the terminal Morton resolution was COM-merged;
    forces for those bodies are approximate beyond the theta contract."""


def group_capacity(n: int, group_size: int, split_level: int, depth: int = 10) -> int:
    """Static group count G = n // B + #split-cells + 1: every split-level
    cell adds at most one partial chunk."""
    return n // group_size + min(8 ** min(split_level, depth), n) + 1


def group_ranges(keys_s: torch.Tensor, n: int, depth: int, group_size: int,
                 split_level: int):
    """Cell-aligned grouping of Morton-sorted bodies: (gstart (G,),
    gcount (G,)) int32, G = group_capacity(...).  Chunks of at most B
    bodies never cross a split-level cell, so a group's bounding box
    stays inside one cell.  Groups are numbered in sorted order, so the
    occupied ones come first and cover [0, n) contiguously.  No host
    sync."""
    b = group_size
    dev = keys_s.device
    sl = min(split_level, depth)
    cell = keys_s >> (3 * (depth - sl))  # nondecreasing: keys are sorted
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    # first body of each body's cell (JAX takes a running max; CUDA's
    # cummax costs ~2.7 ms at 1M bodies, a binary search ~0.1 ms)
    cell_start = torch.searchsorted(cell, cell)
    new_group = (idx - cell_start) % b == 0
    gid = torch.cumsum(new_group, dim=0) - 1

    g_max = group_capacity(n, b, sl, depth)
    gcount = torch.zeros(g_max, dtype=torch.int64, device=dev)
    gcount.index_add_(0, gid, torch.ones(n, dtype=torch.int64, device=dev))
    gstart = torch.where(gcount > 0, torch.cumsum(gcount, 0) - gcount, 0)
    return gstart.to(torch.int32), gcount.to(torch.int32)


def group_bodies(keys_s: torch.Tensor, n: int, depth: int, group_size: int,
                 split_level: int):
    """(gstart (G,), gcount (G,), group_idx (G, B), group_valid (G, B)),
    as ``nbody_tpu.ops.barneshut.group_bodies``.  Pad slots repeat the
    group's first body.  The fused path uses ``group_ranges`` alone: its
    kernel reads each group's contiguous sorted range directly."""
    gstart, gcount = group_ranges(keys_s, n, depth, group_size, split_level)
    slots = torch.arange(group_size, dtype=torch.int32, device=keys_s.device)[None, :]
    group_valid = slots < gcount[:, None]
    group_idx = torch.where(group_valid, gstart[:, None] + slots, gstart[:, None])
    return gstart, gcount, group_idx.clamp(0, n - 1), group_valid


def compact_groups(gstart, gcount, group_idx, group_valid, keep: int):
    """Pack occupied groups to the front (stable, so they keep Morton
    order) and trim the capacity to `keep`.  Returns the packed arrays and
    the number of OCCUPIED groups trimmed, a 0-dim tensor that must be 0
    for correct forces.  `group_idx`/`group_valid` may be None (the fused
    path carries no slot arrays); they are then returned as None."""
    keep = min(keep, gstart.shape[0])
    order = torch.argsort((gcount == 0).to(torch.int32), stable=True)
    gc_sorted = gcount[order]
    trimmed = (gc_sorted[keep:] > 0).sum()

    def take(a):
        return None if a is None else a[order][:keep]

    return take(gstart), gc_sorted[:keep], take(group_idx), take(group_valid), trimmed
