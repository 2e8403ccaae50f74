"""Flat (occupancy-sized) group traversal — counterpart of
``nbody_tpu/ops/bh_traverse_flat.py`` (``default_flat_sizes``,
``_segmented_rank``, ``traverse_flat``).

The padded traversal (``ops/bh_traverse.py``) keeps a (G, F) frontier
where F must cover the worst single group.  This one keeps the frontier
flat: one 1-D array of (group, node) entries whose static capacity tracks
each level's occupancy.  Per level:

  1. 1-D gathers of node count/COM and of the group's (dequantised) box
  2. the padded traversal's classification (far -> COM, near with
     <= leaf_cap bodies -> exact bodies, else expand; terminal over-full
     cells -> COM)
  3. per-group destinations from a segmented rank, then 1-D scatters into
     the flattened per-group lists
  4. near-field ranges carry their list destination from the moment they
     are recorded, so the final body materialisation is one ragged
     expansion with no ordering assumption
  5. child expansion compacted by one cumsum + scatter

Kept exactly as in JAX, since they decide what the traversal opens:

* group boxes are quantised to 10 bits per axis over the root cube in f32
  whatever the run's dtype (lo rounded down, hi up, so the MAC stays
  conservative), and dequantised in f32 (JAX packs the cells into two
  int32 words per group and unpacks them per entry; the port keeps the
  six dequantised f32 corners per group, the same values); only dist² is
  cast to the run's dtype, so in f64 the displacement promotes to f64 as in
  jnp;
* an empty group (box at the 1e18 sentinel) far-accepts the root at once.

Torch stand-ins: JAX's out-of-range ``mode="drop"`` writes go to one
sentinel slot past the end that is sliced off.  JAX's segment ops are
order-free; here the frontier's entries stay in group order (``_bounds``),
so segment sums and ranks are prefix sums at the groups' boundaries, which
needs no atomics (on the card, ~1M atomic adds into ~1,000 group slots
cost ~0.2 ms a call).  The ragged expansion's ``.at[cum].max`` plus
``lax.cummax`` is a ``searchsorted`` over the ranges' offsets, which gives
every slot the same owning range (``owning_ranges``).

Overflow is reported as EXCESS over the static capacities (0 = fits) in
the frontier and ranges channels of ``TraverseStats``.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops.bh_traverse import TraverseStats, _excl
from nbody_tpu_torch.ops.bh_tree import TreeLevel


def _bounds(gid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment g's entries are [bounds[g], bounds[g + 1]).  The flat
    frontier keeps its entries in group order, with the sentinel gid
    (num_segments) of invalid entries at the tail: level 0 lists the groups
    in order and each level writes a parent's children where the parent
    was, so a binary search finds every segment."""
    g = torch.arange(num_segments + 1, dtype=gid.dtype, device=gid.device)
    return torch.searchsorted(gid, g)


def _segment_sum(x: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Integer segment sums over the segments of `bounds` (invalid entries
    past the last segment are dropped): prefix sums at the boundaries, so
    no atomics."""
    csum = torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])
    return csum[bounds[1:]] - csum[bounds[:-1]]


def _segmented_rank(weights: torch.Tensor, gid_c: torch.Tensor,
                    bounds: torch.Tensor) -> torch.Tensor:
    """Per-entry exclusive rank within its segment: the exclusive cumsum
    minus its value at the segment's first entry, which is the segment's
    smallest (JAX takes segment_min, so it needs no order).  Only entries
    of a (so non-empty) segment use their rank."""
    csum = _excl(weights)
    base = csum[bounds[:-1].clamp_max(csum.shape[0] - 1)]
    return csum - base[gid_c]


def owning_ranges(rc: torch.Tensor, body_cap: int) -> torch.Tensor:
    """For each body slot j < body_cap of the ragged expansion of ranges
    with counts `rc`, the range that owns it: the last range with rc > 0
    whose exclusive offset is <= j (0 if there is none).  JAX scatters each
    non-empty range's index at its offset and takes a running max; the
    offsets are sorted, so a binary search finds the same range."""
    cum = _excl(rc)
    j = torch.arange(body_cap, dtype=cum.dtype, device=cum.device)
    rid = torch.searchsorted(cum, j, right=True) - 1
    # slots past the last body: JAX's running max stops at the last
    # non-empty range
    idx = torch.arange(rc.shape[0], dtype=cum.dtype, device=cum.device)
    last = torch.where(rc > 0, idx, 0).max()
    return torch.minimum(rid.clamp_min(0), last)


def default_flat_sizes(n_groups: int, depth: int) -> tuple[int, ...]:
    """Static per-level flat-frontier capacities: 8x the possible node
    count at shallow levels, an empirical ~1024 entries per group around
    the occupancy spike, tapering for deep levels (the JAX schedule).
    Overflow is detected at run time through TraverseStats."""
    sizes = []
    for d in range(depth + 1):
        schedule = {6: 640, 7: 128}
        per_group = min(8 ** min(d, 8), schedule.get(d, 1024 if d <= 5 else 64))
        k = n_groups * max(per_group, 1) + 8192
        floor = min(32_768, (n_groups + 1) * 8 ** min(d, 5))
        sizes.append(int(min(max(k, floor, 1024), 16_777_216)))
    return tuple(sizes)


def body_capacity(n_groups: int, list_size: int) -> int:
    """Static capacity of the near-field body store: near bodies are a
    subset of the list entries, so G * list_size is a hard bound."""
    return int(min(max(n_groups * 5120, 1 << 19), n_groups * list_size, 16_777_216))


def _quantize(v: torch.Tensor, half0, inv_q, up: bool) -> torch.Tensor:
    """10-bit cell of each coordinate over the root cube, in f32: rounded
    down (lo) or up (hi, stored as ceil - 1 so three axes fit 30 bits)."""
    x = (v.to(torch.float32) + half0) * inv_q
    if up:
        return torch.ceil(x).clamp(1, 1024).to(torch.int64) - 1
    return torch.floor(x).clamp(0, 1023).to(torch.int64)


def traverse_flat(
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
    list_size: int,
    range_size: int = 512,
    flat_sizes: tuple[int, ...] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, TraverseStats]:
    """Flat traversal: (lists (G, M, 4) rows [x y z G·m], lengths (G,)
    int32, stats).  `range_size` is the mean near-field ranges per group
    (the flat range store holds n_groups * range_size).  No host sync."""
    n = pos_sorted.shape[0]
    n_groups = group_lo.shape[0]
    M, cap = list_size, leaf_cap
    depth = len(levels) - 1
    dtype = pos_sorted.dtype
    dev = pos_sorted.device
    i64, f32 = torch.int64, torch.float32
    if flat_sizes is None:
        flat_sizes = default_flat_sizes(n_groups, depth)

    theta_sq = torch.tensor(theta * theta, dtype=dtype, device=dev)
    gG = torch.tensor(G_const, dtype=dtype, device=dev)
    far_d2 = torch.tensor(1.0e30, dtype=dtype, device=dev)
    SENT = n_groups  # gid of an invalid entry: dropped by the segment ops

    # group boxes, quantised to two packed words (f32 whatever the dtype)
    # and dequantised once per group, as JAX does once per entry
    b32 = border0.to(f32)
    half0 = 0.5 * b32
    qcell = b32 / 1024.0
    inv_q = torch.full_like(b32, 1024.0) / b32
    empty_grp = group_lo[:, 0] > 1.0e17  # flagged in bit 30 of JAX's lo word
    qlo = torch.stack([_quantize(group_lo[:, a], half0, inv_q, False) for a in range(3)], 1)
    qhi = torch.stack([_quantize(group_hi[:, a], half0, inv_q, True) for a in range(3)], 1)
    box = torch.cat([qlo.to(f32) * qcell - half0, (qhi + 1).to(f32) * qcell - half0], 1)
    box = box.to(dtype)  # exact; in f64 the clip below promotes, as in jnp

    # rows g * M + slot, and row G * M the sentinel that takes dropped writes
    LIN_SENT = n_groups * M
    lists_flat = torch.zeros((LIN_SENT + 1, 4), dtype=dtype, device=dev)
    total_len = torch.zeros(n_groups, dtype=i64, device=dev)

    flat_R = int(max(n_groups * range_size, 32_768))
    r_start = torch.zeros(flat_R + 1, dtype=i64, device=dev)
    r_count = torch.zeros(flat_R + 1, dtype=i64, device=dev)
    r_dest = torch.full((flat_R + 1,), LIN_SENT, dtype=i64, device=dev)
    r_len = torch.zeros((), dtype=i64, device=dev)
    need_ranges_tot = torch.zeros((), dtype=i64, device=dev)
    need_frontier = torch.zeros((), dtype=i64, device=dev)  # worst EXCESS
    term_res = torch.zeros(n_groups, dtype=i64, device=dev)

    # the flat frontier at level 0: every group at the root
    k0 = max(flat_sizes[0], n_groups)
    arange0 = torch.arange(k0, device=dev)
    fvalid = arange0 < n_groups
    fgid = torch.where(fvalid, arange0, SENT)
    fnid = torch.zeros(k0, dtype=i64, device=dev)

    for d, lvl in enumerate(levels):
        border_d = border0.to(dtype) / torch.tensor(2.0**d, dtype=dtype, device=dev)
        gid = fgid
        nid = torch.where(fvalid, fnid, 0).clamp(0, lvl.capacity - 1)
        gid_c = gid.clamp(0, n_groups - 1)

        cnt = torch.where(fvalid, lvl.count[nid].long(), 0)
        com = lvl.com[nid]
        cx, cy, cz = com[:, 0], com[:, 1], com[:, 2]
        bx = box[gid_c]  # (k, 6) lo xyz, hi xyz
        bounds = _bounds(gid, n_groups)
        d3 = com - torch.minimum(torch.maximum(com, bx[:, :3]), bx[:, 3:])
        sq = d3 * d3
        # empty groups: an immediate far-accept of the root
        dist2 = torch.where(empty_grp[gid_c], far_d2, (sq[:, 0] + sq[:, 1] + sq[:, 2]).to(dtype))

        exists = cnt > 0
        far = exists & (theta_sq * dist2 > border_d * border_d)
        near = exists & ~far & ((cnt <= cap) | (d == depth))
        take_com = far | (near & (cnt > cap))  # terminal over-full -> COM
        take_body = near & (cnt <= cap)
        expand = exists & ~take_com & ~take_body
        term_res += _segment_sum(torch.where(near & (cnt > cap), cnt, 0), bounds)

        # COM entries
        tc = take_com.long()
        dest = total_len[gid_c] + _segmented_rank(tc, gid_c, bounds)
        lin = torch.where(take_com & (dest < M), gid_c * M + dest, LIN_SENT)
        gm_e = torch.where(take_com, gG * lvl.mass[nid], 0.0).to(dtype)
        lists_flat[lin] = torch.stack([cx, cy, cz, gm_e], dim=-1)
        total_len += _segment_sum(tc, bounds)

        # near-field ranges with their destinations
        tb_cnt = torch.where(take_body, cnt, 0)
        dest_b = total_len[gid_c] + _segmented_rank(tb_cnt, gid_c, bounds)
        lin_b0 = torch.where(take_body & (dest_b + tb_cnt <= M), gid_c * M + dest_b,
                             LIN_SENT)
        tb = take_body.long()
        rpos = r_len + _excl(tb)
        rpos = torch.where(take_body & (rpos < flat_R), rpos, flat_R)
        r_start[rpos] = lvl.start[nid].long()
        r_count[rpos] = tb_cnt
        r_dest[rpos] = lin_b0
        n_tb = tb.sum()
        need_ranges_tot += n_tb
        r_len = torch.clamp_max(r_len + n_tb, flat_R)
        total_len += _segment_sum(tb_cnt, bounds)

        # children into the next flat frontier
        if d < depth:
            k_next = flat_sizes[d + 1]
            cc = torch.where(expand, lvl.child_count[nid].long(), 0)
            cs = lvl.child_start[nid].long()
            n_children = cc.sum()
            need_frontier = torch.maximum(need_frontier, n_children - k_next)
            offs8 = torch.arange(8, device=dev)
            cdest = _excl(cc)[:, None] + offs8
            cdest = torch.where((offs8 < cc[:, None]) & (cdest < k_next), cdest, k_next)
            fnid = torch.zeros(k_next + 1, dtype=i64, device=dev)
            fnid[cdest] = cs[:, None] + offs8
            fgid_new = torch.full((k_next + 1,), SENT, dtype=i64, device=dev)
            fgid_new[cdest] = gid[:, None].expand_as(cdest)
            fnid = fnid[:k_next]
            fvalid = torch.arange(k_next, device=dev) < torch.clamp_max(n_children, k_next)
            fgid = torch.where(fvalid, fgid_new[:k_next], SENT)

    # near-field bodies, padding-free: O(total near bodies), not O(ranges x cap)
    rc = r_count[:flat_R]
    cum = _excl(rc)
    body_total = rc.sum()
    body_cap = body_capacity(n_groups, M)
    rid = owning_ranges(rc, body_cap)
    j = torch.arange(body_cap, device=dev)
    jvalid = j < torch.clamp_max(body_total, body_cap)
    off_in_range = j - cum[rid]
    bidx = (r_start[rid] + off_in_range).clamp(0, n - 1)
    rdst = r_dest[rid]
    lin_b = torch.where(jvalid & (rdst != LIN_SENT), rdst + off_in_range, LIN_SENT)
    gm_b = torch.where(jvalid, gm_sorted[bidx], 0.0).to(dtype)
    lists_flat[lin_b] = torch.cat([pos_sorted[bidx], gm_b[:, None]], dim=1)
    ranges_excess = torch.clamp_min(need_ranges_tot - flat_R, 0)
    body_excess = torch.clamp_min(body_total - body_cap, 0)

    stats = TraverseStats(
        max_list_needed=total_len.max(),
        max_frontier_needed=need_frontier,
        max_ranges_needed=torch.maximum(ranges_excess, body_excess),
        terminal_com_bodies=term_res.max(),
    )
    lengths = torch.clamp_max(total_len, M).to(torch.int32)
    return lists_flat[:LIN_SENT].view(n_groups, M, 4), lengths, stats
