"""Morton (Z-order) keys of body positions — counterpart of
``nbody_tpu/ops/morton.py``.

Positions are quantised onto a 2^depth grid per axis over the root cube
centred at the origin with border = 2·max|coordinate| (the reference's
cube, serial/barnes-hut.c:326-344), and the cell's bits are interleaved
z·4 + y·2 + x (serial/barnes-hut.c:114-133).  A node of the reference
octree at depth d is the set of bodies sharing a 3d-bit key prefix.

The keys equal the JAX package's exactly: the scaling is done in the
border's dtype (f32 for f32 input), truncated toward zero and clipped to
[0, 2^depth - 1], and the sort is stable so tied keys keep input order.

Also here, the Morton group rule that every Barnes-Hut engine (the list
path, the fused path and the persistent layout) cuts its groups by:
``auto_split_level``, ``group_capacity``, ``group_ranges``,
``group_bodies`` and ``compact_groups`` (the JAX package keeps them in
``nbody_tpu/ops/barneshut.py`` and ``bh_fused.py``).
"""

from __future__ import annotations

import math

import torch


def bounding_border(pos: torch.Tensor) -> torch.Tensor:
    """Root cube border, 2·max|coordinate|, in the input dtype (a 0-dim
    tensor on pos's device, so no host sync)."""
    return 2.0 * pos.abs().max()


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits so there are two zero bits between each."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_encode(pos: torch.Tensor, border: torch.Tensor, depth: int) -> torch.Tensor:
    """int32 Morton keys (N,) of the depth-level cells holding each body."""
    if not 1 <= depth <= 10:
        raise ValueError(f"depth must be in [1, 10] for int32 keys, got {depth}")
    # JAX divides the f32 positions by the border in the border's dtype
    # (f64 under --dtype f64); a 0-dim f64 tensor would not promote here.
    p = pos.to(torch.float32).to(border.dtype)
    scaled = (p / border + 0.5) * float(2**depth)
    cell = scaled.to(torch.int32).clamp_(0, 2**depth - 1)
    return _spread3(cell[:, 0]) | (_spread3(cell[:, 1]) << 1) | (_spread3(cell[:, 2]) << 2)


def morton_sort(pos: torch.Tensor, depth: int, border: torch.Tensor | None = None):
    """(perm, keys, border): the stable permutation sorting bodies by key.

    `border` overrides the bounding cube; out-of-cube positions clip into
    edge cells."""
    if border is None:
        border = bounding_border(pos)
    keys = morton_encode(pos, border, depth)
    perm = torch.argsort(keys, stable=True)
    return perm, keys, border


def auto_split_level(n: int, b: int) -> int:
    """Coarse-cell level for group chunking: cells hold ~2B bodies, so
    B-body chunks inside a cell stay mostly full.  Rounded to the nearest
    level (rounding up can put the cell count far above n/2B)."""
    return max(0, round(math.log(max(n / (2.0 * b), 1.0), 8)))


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
