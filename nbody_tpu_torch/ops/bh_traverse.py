"""Padded group traversal — counterpart of ``nbody_tpu/ops/bh_traverse.py``
(``TraverseStats``, ``traverse``).

Every Morton group of bodies walks the level tree breadth first with a
dense (G, F) frontier.  For each level d and frontier node:

  far   θ² · dist²(group box, node COM) > border_d²
        -> the node's (COM, G·m) is one source (the reference's
           border/dist < θ, serial/barnes-hut.c:405, with dist the box's
           minimum distance, as the warp-wide vote of cuda/barnes-hut.cu)
  near  the node holds <= leaf_cap bodies (or the level is the last)
        -> its bodies are exact sources (an over-full terminal cell falls
           back to its COM, counted in terminal_com_bodies)
  else  -> its children join the next frontier.

Plain tensor glue, as in JAX.  JAX's out-of-range ``.at[...].set(...,
mode="drop")`` becomes a write into one sentinel slot past the end (row
G·M of the flattened lists, column R or F) that is sliced off.  Each real
(group, slot) is written at most
once, so ``index_put_`` without accumulate is deterministic where it
matters.

The lists come out as (G, M, 4) rows [x y z G·m] with zero-G·m padding:
JAX's planar (G, 4, M) is the TPU kernel's layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nbody_tpu_torch.ops.bh_tree import TreeLevel


class TraverseStats(NamedTuple):
    """0-dim int tensors (no host sync until read)."""

    max_list_needed: torch.Tensor  # most sources any group needs
    max_frontier_needed: torch.Tensor  # widest frontier any group hit
    #   (the flat traversal reports its per-level EXCESS instead, 0 = fits)
    max_ranges_needed: torch.Tensor  # most near-field ranges any group hit
    #   (flat: the EXCESS of its range and body stores, 0 = fits)
    terminal_com_bodies: torch.Tensor  # bodies COM-merged in over-full
    #   terminal cells (per group, worst case): an accuracy residual


def _excl(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim) - x


def _dist2(com: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Squared distance from the boxes [lo, hi] to the points `com`, summed
    x, y, z in that order (the order of JAX's three-element sum)."""
    d = com - torch.minimum(torch.maximum(com, lo), hi)
    sq = d * d
    return sq[..., 0] + sq[..., 1] + sq[..., 2]


def traverse(
    levels: list[TreeLevel],
    border0: torch.Tensor,
    group_lo: torch.Tensor,
    group_hi: torch.Tensor,
    pos_sorted: torch.Tensor,
    gm_sorted: torch.Tensor,
    *,
    G_const: float,
    theta: float,
    leaf_cap: int,
    frontier_size: int,
    range_size: int,
    list_size: int,
) -> tuple[torch.Tensor, torch.Tensor, TraverseStats]:
    """Per-group source lists (far COMs, then exact near bodies).

    Returns (lists (G, M, 4) rows [x y z G·m], lengths (G,) int32, stats).
    No host sync."""
    n = pos_sorted.shape[0]
    n_groups = group_lo.shape[0]
    F, R, M, cap = frontier_size, range_size, list_size, leaf_cap
    depth = len(levels) - 1
    dtype = pos_sorted.dtype
    dev = pos_sorted.device
    i64 = torch.int64

    g_rows = torch.arange(n_groups, device=dev)[:, None]
    theta_sq = torch.tensor(theta * theta, dtype=dtype, device=dev)
    gG = torch.tensor(G_const, dtype=dtype, device=dev)

    # rows g * M + slot, and row G * M the sentinel that takes dropped writes
    lin_sent = n_groups * M
    lists = torch.zeros((lin_sent + 1, 4), dtype=dtype, device=dev)
    total_len = torch.zeros(n_groups, dtype=i64, device=dev)
    range_start = torch.zeros((n_groups, R + 1), dtype=i64, device=dev)
    range_count = torch.zeros((n_groups, R + 1), dtype=i64, device=dev)
    range_len = torch.zeros(n_groups, dtype=i64, device=dev)
    need_ranges = torch.zeros(n_groups, dtype=i64, device=dev)
    need_frontier = torch.zeros((), dtype=i64, device=dev)
    term_res = torch.zeros(n_groups, dtype=i64, device=dev)

    frontier = torch.full((n_groups, F), -1, dtype=i64, device=dev)
    frontier[:, 0] = 0  # the root
    lo, hi = group_lo[:, None, :], group_hi[:, None, :]

    for d, lvl in enumerate(levels):
        border_d = border0 / torch.tensor(2.0**d, dtype=dtype, device=dev)
        valid = frontier >= 0
        idc = frontier.clamp(0, lvl.capacity - 1)
        com = lvl.com[idc]  # (G, F, 3)
        m = lvl.mass[idc]
        cnt = torch.where(valid, lvl.count[idc].long(), 0)
        start = lvl.start[idc].long()

        dist2 = _dist2(com, lo, hi)
        exists = cnt > 0
        far = exists & (theta_sq * dist2 > border_d * border_d)
        near = exists & ~far & ((cnt <= cap) | (d == depth))
        take_com = far | (near & (cnt > cap))
        take_body = near & (cnt <= cap)
        expand = exists & ~take_com & ~take_body
        term_res += torch.where(near & (cnt > cap), cnt, 0).sum(1)

        # far and terminal COM entries
        tc = take_com.long()
        dest = total_len[:, None] + _excl(tc)
        lin = torch.where(take_com & (dest < M), g_rows * M + dest, lin_sent)
        lists[lin] = torch.cat([com, (gG * m)[..., None]], dim=-1)  # (G, F, 4)
        total_len += tc.sum(1)

        # near-field body ranges
        tb = take_body.long()
        rdest = range_len[:, None] + _excl(tb)
        rdest = torch.where(take_body & (rdest < R), rdest, R)
        range_start[g_rows, rdest] = start
        range_count[g_rows, rdest] = cnt
        n_ranges = tb.sum(1)
        need_ranges += n_ranges
        range_len = torch.clamp_max(range_len + n_ranges, R)

        # the next frontier
        if d < depth:
            cs = lvl.child_start[idc].long()
            cc = torch.where(expand, lvl.child_count[idc].long(), 0)
            offs = torch.arange(8, device=dev)
            flat_ids = (cs[..., None] + offs).reshape(n_groups, F * 8)
            flat_valid = (offs < cc[..., None]).reshape(n_groups, F * 8)
            fv = flat_valid.long()
            fdest = _excl(fv)
            need_frontier = torch.maximum(need_frontier, fv.sum(1).max())
            fdest = torch.where(flat_valid & (fdest < F), fdest, F)
            nxt = torch.full((n_groups, F + 1), -1, dtype=i64, device=dev)
            nxt[g_rows, fdest] = flat_ids
            frontier = nxt[:, :F]

    # near-field bodies, one batched gather
    range_start, range_count = range_start[:, :R], range_count[:, :R]
    offs = torch.arange(cap, device=dev)
    bidx = (range_start[..., None] + offs).clamp(0, n - 1)  # (G, R, C)
    bvalid = offs < range_count[..., None]
    base = total_len[:, None] + _excl(range_count)
    bdest = base[..., None] + offs
    lin = torch.where(bvalid & (bdest < M), g_rows[..., None] * M + bdest, lin_sent)
    lists[lin] = torch.cat([pos_sorted[bidx], gm_sorted[bidx][..., None]], dim=-1)

    need_len = total_len + range_count.sum(1)
    lengths = torch.clamp_max(need_len, M).to(torch.int32)
    stats = TraverseStats(
        max_list_needed=need_len.max(),
        max_frontier_needed=need_frontier,
        max_ranges_needed=need_ranges.max(),
        terminal_com_bodies=term_res.max(),
    )
    return lists[:lin_sent].view(n_groups, M, 4), lengths, stats
