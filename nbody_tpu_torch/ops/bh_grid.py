"""Dense-grid octree — counterpart of ``nbody_tpu/ops/bh_grid.py``
(``grid_offsets``, ``GridTree``, ``build_grid``, ``grid_from_terminal``).

Levels 0..ld are stored as complete 8^d grids in which a cell's id is its
Morton prefix, so the children of cell c at level d are always cells
[8c, 8c+8) at level d+1 and the tree has no links.  Each cell holds its
centre of mass, G·mass, body count and first body (in Morton-sorted
order).  The reference analog is the pointer-insert build
(serial/barnes-hut.c:169-317).

The terminal level is one segmented sum over the sorted bodies; coarser
levels are (-1, 8) reshape-sums.  The segmented sum must be deterministic
on the card, since the tables decide what the traversal opens: CUDA's
``index_add_`` on floats uses atomics, so the sum here is
``torch.segment_reduce`` over the contiguous runs that Morton order gives
each terminal cell.

``grid_from_terminal`` builds the grid from terminal-level accumulators
and per-cell slot ranges in a layout the caller evaluates from (the
persistent group layout, ``ops/bh_persistent.py``): there ``cnt`` is a
span of slots, pads included, not a count of bodies.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def grid_offsets(ld: int) -> tuple[int, ...]:
    """Flat offsets of each dense level: OFF[d] = (8^d - 1) // 7."""
    return tuple((8**d - 1) // 7 for d in range(ld + 2))


class GridTree(NamedTuple):
    """Dense levels 0..ld concatenated, each field (T,) with
    T = (8^(ld+1) - 1) // 7; cell t = OFF[d] + morton_prefix."""

    cx: torch.Tensor  # f32 centre of mass x
    cy: torch.Tensor
    cz: torch.Tensor
    gm: torch.Tensor  # f32 G * total mass
    cnt: torch.Tensor  # i32 body count
    start: torch.Tensor  # i32 first body index (sorted order)

    @property
    def total(self) -> int:
        return self.cx.shape[0]

    @classmethod
    def from_numpy(cls, device=None, **fields) -> "GridTree":
        """A tree from arrays such as the JAX package's ``GridTree`` fields
        ((1, T) or (T,)): floats become f32, counts and starts i32."""
        out = {}
        for name in cls._fields:
            a = np.array(fields[name]).reshape(-1)  # a writable copy
            dtype = torch.int32 if name in ("cnt", "start") else torch.float32
            out[name] = torch.as_tensor(a, device=device).to(dtype).contiguous()
        return cls(**out)


def build_grid(
    pos_sorted: torch.Tensor,
    gm_sorted: torch.Tensor,
    keys_sorted: torch.Tensor,
    depth: int,
    ld: int,
) -> GridTree:
    """Dense levels 0..ld from Morton-sorted f32 bodies; gm_sorted is
    G·mass.  No host sync."""
    n = pos_sorted.shape[0]
    dev = pos_sorted.device
    k_terminal = 8**ld
    nid = (keys_sorted >> (3 * (depth - ld))).long()

    cnt = torch.zeros(k_terminal, dtype=torch.int64, device=dev)
    cnt.index_add_(0, nid, torch.ones(n, dtype=torch.int64, device=dev))
    wg = torch.cat([gm_sorted[:, None] * pos_sorted, gm_sorted[:, None]], dim=1)
    # sorted keys make each cell a contiguous run, so the lengths are
    # exact and the sum is a fixed-order loop per cell (no atomics)
    sums = torch.segment_reduce(wg, "sum", lengths=cnt, axis=0, unsafe=True)

    levels = [sums]  # (8^d, 4) [G·m·x, G·m·y, G·m·z, G·m], terminal first
    counts = [cnt]
    for _ in range(ld):
        levels.append(levels[-1].reshape(-1, 8, 4).sum(dim=1))
        counts.append(counts[-1].reshape(-1, 8).sum(dim=1))
    start_t = torch.cumsum(cnt, 0) - cnt
    starts = [start_t]
    for _ in range(ld):
        starts.append(starts[-1].reshape(-1, 8)[:, 0])
    levels.reverse(), counts.reverse(), starts.reverse()  # level 0 first

    w = torch.cat(levels, dim=0)
    gm = w[:, 3]
    com = w[:, :3] / torch.clamp_min(gm, 1e-30)[:, None]
    return GridTree(
        cx=com[:, 0].contiguous(),
        cy=com[:, 1].contiguous(),
        cz=com[:, 2].contiguous(),
        gm=gm.contiguous(),
        cnt=torch.cat(counts).to(torch.int32),
        start=torch.cat(starts).to(torch.int32),
    )


def grid_from_terminal(w: torch.Tensor, gm: torch.Tensor, cnt: torch.Tensor,
                       start_t: torch.Tensor, end_t: torch.Tensor, ld: int) -> GridTree:
    """Dense levels 0..ld from terminal-level accumulators
    (``nbody_tpu/ops/bh_grid.py:127-165``): `w` (8^ld, 3) the G·m-weighted
    positions, `gm` (8^ld,) G·m, `cnt` (8^ld,) the bodies of each cell,
    `start_t`/`end_t` (8^ld,) each cell's first and last + 1 slot in the
    caller's layout, int32 max / -1 where the cell is empty.  Coarse cells
    take the min and max over their 8 children.  The result's ``cnt`` is the
    span end - start (0, with start 0, for an empty cell), so a cell's
    range covers the layout's pad slots between its bodies: those must carry
    G·m = 0."""
    ws, gms, cnts, sts, ens = [w], [gm], [cnt], [start_t], [end_t]
    for _ in range(ld):
        ws.append(ws[-1].reshape(-1, 8, 3).sum(dim=1))
        gms.append(gms[-1].reshape(-1, 8).sum(dim=1))
        cnts.append(cnts[-1].reshape(-1, 8).sum(dim=1))
        sts.append(sts[-1].reshape(-1, 8).amin(dim=1))
        ens.append(ens[-1].reshape(-1, 8).amax(dim=1))
    for seq in (ws, gms, cnts, sts, ens):
        seq.reverse()  # level 0 first
    w_all, gm_all = torch.cat(ws), torch.cat(gms)
    cnt_all, st_all, en_all = torch.cat(cnts), torch.cat(sts), torch.cat(ens)
    com = w_all / torch.clamp_min(gm_all, 1e-30)[:, None]
    occupied = cnt_all > 0
    span = torch.where(occupied, en_all - st_all, 0)
    start = torch.where(occupied, st_all, 0)
    return GridTree(
        cx=com[:, 0].contiguous(),
        cy=com[:, 1].contiguous(),
        cz=com[:, 2].contiguous(),
        gm=gm_all.to(torch.float32),
        cnt=span.to(torch.int32),
        start=start.to(torch.int32),
    )
