"""Fused Barnes-Hut traverse + evaluate — counterpart of
``nbody_tpu/ops/bh_fused.py``.

``fused_group_forces`` wraps kernel K6, ``nbody_tpu_torch/csrc/bh_fused.cu``
(which replaces the Pallas ``_fused_kernel``): per Morton group it walks
the dense grid of ``ops/bh_grid.py`` level by level, accepts far cells as
centre-of-mass sources, ships near cells' bodies exactly, and evaluates
every body of the group against those sources.  A CPU tensor goes to the
plain PyTorch version, ``fused_group_forces_reference``, which makes the
same decisions in the same f32 arithmetic; a CUDA tensor launches the
kernel or raises.  Nothing falls back.  ``fused_group_forces.launches``
counts kernel launches, ``fused_group_forces.evaluations`` the calls
that launched.

The contract is the JAX package's; the TPU mechanics (128-lane octet
packing of the tables, planar (G, 4, B) group blocks, burst rows,
groups per program, interpret mode, the far-vector staging switch) are
not carried over: the kernel reads the ``GridTree`` arrays directly, and
a group's bodies are the contiguous sorted range
[gstart, gstart + gcount).

Stage cuts (the JAX kernel's ``debug_mode``, ``nbody_tpu/ops/bh_fused.py:
201-214``): ``debug_mode`` is one of ``CUTS``.  "full" is production;
"none" launches the kernel and writes zero stats; "pops" traverses and
classifies; "stage" also writes the staging entries ("stagefar" /
"stagenear" one branch only); "dma" also loads the near rows.  Every cut
but "none" returns the stats of "full" and, short of "full", zero forces.
``diag/fused_stages.py`` times them on the card.

Both wrappers price the groups with the "pops" cut first and launch the
heaviest first: two kernel launches an evaluation.  The f32 kernel runs a
block per group slot, in ``heavy_first`` order; the df kernel a block per
piece of a group (``df_pieces``: runs of whole warps, at most DF_THREADS
bodies), the pieces heaviest first (``df_launch_pieces``).  Each evaluator
carries its pricing pass alone as ``.price`` (``price_groups``,
``bh_fused_df.price_groups_df``, ``price_groups_reference``): the stats of
"full" and no forces, all that the start-up probe ``check_fused`` reads.

Stats lanes per group (int32): pops (frontier cells classified),
staged sources (far children + near bodies: actual sources, where the
JAX package counts its 128-lane filler), near bodies, frontier overflow
(the largest needed frontier when it reached the cap, else 0) and far
children.  The JAX package's ``eval_rows`` lane counts TPU rows and is
dropped.

The MAC is always f32, as in the JAX package.  For f64 bodies the path
runs in K6's df mode (``ops/bh_fused_df.py``, the counterpart of
``nbody_tpu/ops/bh_fused_df.py``): f64 tables, sources and evaluation,
with the MAC on the f32-rounded tables and bodies, so f32 and df runs on
the same tables open and accept the same cells.  The plain version takes
both modes from src's dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from nbody_tpu_torch.core import capacity, constants
from nbody_tpu_torch.diag.timing import host_sync, span, spanned
from nbody_tpu_torch.ops.bh_grid import GridTree, build_grid, grid_offsets
from nbody_tpu_torch.ops.cuda_exhaustive import check_tensor, cuda_rect_accelerations
from nbody_tpu_torch.ops.morton import (
    auto_split_level,
    compact_groups,
    group_capacity,
    group_ranges,
    morton_sort,
)

FRONTIER_CAP = 2048  # cells per level per group (runtime overflow-checked)
MAX_LD = 8  # deepest dense grid the kernel takes (robust mode's depth)
MAX_GROUP_SIZE = 1024  # the kernel runs one block per group, two bodies a thread
MORTON_DEPTH = 10

# stats lanes (per group)
S_POPS, S_SRC, S_NEAR, S_OVF, S_FAR = 0, 1, 2, 3, 4
N_STATS = 5

# the JAX kernel's debug_mode cuts, in the kernel's numbering
CUTS = ("none", "pops", "stage", "stagefar", "stagenear", "dma", "full")

# (bodies x sources) pairs the plain version evaluates at once
_PAIR_BLOCK = 1 << 22


def auto_ld(n: int) -> int:
    """Dense-grid terminal level: ~16 bodies per terminal cell, clamped to
    [2, 6]."""
    return min(6, max(2, math.ceil(math.log(max(n / 16.0, 1.0), 8))))


def _round_cap(frontier_cap: int) -> int:
    """The frontier cap the traversal uses: a multiple of 128, as in JAX."""
    return -(-int(frontier_cap) // 128) * 128


def _theta_sq(theta: float) -> float:
    """θ² as the value the f32 MAC multiplies by: JAX squares in Python and
    its f32 multiply rounds that to f32."""
    return float(np.float32(float(theta) * float(theta)))


def check_ld(ld: int) -> None:
    """Raises unless the kernel takes a grid of depth `ld`."""
    if not 1 <= ld <= MAX_LD:
        raise ValueError(f"ld must be in [1, {MAX_LD}], got {ld}")


def check_debug_mode(debug_mode: str) -> int:
    """The kernel's number of stage cut `debug_mode`; raises on any other
    string."""
    if debug_mode not in CUTS:
        raise ValueError(f"debug_mode must be one of {CUTS}, got {debug_mode!r}")
    return CUTS.index(debug_mode)


def _check_kernel_inputs(tree: GridTree, gstart, gcount, src, bsq, ld: int,
                         dtype: torch.dtype):
    device = src.device
    n = src.shape[0]
    check_tensor("src", src, (n, 4), device, dtype)
    t = grid_offsets(ld)[ld + 1]
    for name in ("cx", "cy", "cz", "gm"):
        check_tensor(f"tree.{name}", getattr(tree, name), (t,), device, dtype)
    for name, a, size in (("tree.cnt", tree.cnt, t), ("tree.start", tree.start, t),
                          ("gstart", gstart, -1), ("gcount", gcount, gstart.shape[0])):
        if a.dtype != torch.int32 or a.device != device or not a.is_contiguous():
            raise TypeError(f"{name}: expected contiguous int32 on {device}, "
                            f"got {a.dtype} on {a.device}")
        if a.dim() != 1 or size not in (-1, a.shape[0]):
            raise ValueError(f"{name}: shape {tuple(a.shape)}, expected ({size},)")
    check_tensor("bsq", bsq, (-1,), device)
    if bsq.shape[0] < ld + 1:
        raise ValueError(f"bsq: {bsq.shape[0]} levels, need ld + 1 = {ld + 1}")
    if src.data_ptr() % 16:
        raise ValueError("src: the kernel reads 16-byte vector rows, so it must "
                         "be 16-byte aligned")


def launch(lib, tree: GridTree, gstart, gcount, src, bsq, stream, *, theta: float,
           eps2: float, leaf_cap: int, ld: int, group_size: int, frontier_cap: int,
           debug_mode: str = "full", cut_entry: bool = False, order=None, pieces=None):
    """Call K6's launcher in `lib` on checked tensors, in the f32 mode or,
    for f64 `src` and tables, the df mode, at stage cut `debug_mode`;
    returns (cudaError_t, accelerations (n, 3) in src's dtype, stats (G,
    N_STATS)).  "full" goes through the production entry point unless
    `cut_entry`.  `order` (f32 only; int32 (G,), a permutation of the
    slots, or None for slot order) is the order in which the blocks take
    the group slots; `pieces` (df only; int32 (P, 3) from ``df_pieces``, or
    None for the groups' base pieces in slot order) the df blocks' pieces.
    The tensors' pointers are handed to the kernel as they are, so the CPU
    emulation of the kernel source takes the same call."""
    cut = check_debug_mode(debug_mode)
    n, n_groups = src.shape[0], gstart.shape[0]
    out = torch.zeros((n, 3), dtype=src.dtype, device=src.device)
    if src.dtype == torch.float64:
        if order is not None:
            raise ValueError("the df mode takes a piece table, not a slot order")
        if pieces is None:
            pieces = df_pieces(gcount, group_size)
        stats = torch.zeros((n_groups, N_STATS), dtype=torch.int32, device=src.device)
        table, count = pieces.data_ptr(), pieces.shape[0]
        fn, cut_fn = lib.nbody_bh_fused_f64, lib.nbody_bh_fused_f64_cut
    else:
        if pieces is not None:
            raise ValueError("the f32 mode takes a slot order, not a piece table")
        stats = torch.empty((n_groups, N_STATS), dtype=torch.int32, device=src.device)
        table, count = (None if order is None else order.data_ptr()), n_groups
        fn, cut_fn = lib.nbody_bh_fused_f32, lib.nbody_bh_fused_f32_cut
    extra = ()
    if debug_mode != "full" or cut_entry:
        fn, extra = cut_fn, (cut,)
    err = fn(
        tree.cx.data_ptr(), tree.cy.data_ptr(), tree.cz.data_ptr(),
        tree.gm.data_ptr(), tree.cnt.data_ptr(), tree.start.data_ptr(),
        gstart.data_ptr(), gcount.data_ptr(), table, count, src.data_ptr(),
        bsq.data_ptr(), _theta_sq(theta), float(eps2),
        int(leaf_cap), int(ld), _round_cap(frontier_cap), int(group_size),
        out.data_ptr(), stats.data_ptr(), stream, *extra,
    )
    return err, out, stats


def kernel_forces(dtype: torch.dtype, tree: GridTree, gstart, gcount, src, bsq, *,
                  theta: float, eps2: float, leaf_cap: int, ld: int, group_size: int,
                  frontier_cap: int, debug_mode: str = "full", order=None,
                  pieces=None, cut_entry: bool = False):
    """Check the inputs and launch K6 on the card, in the mode of `dtype`
    (f32, or f64 for the df mode), at stage cut `debug_mode`, taking the
    group slots in `order` (f32 only, None for slot order) or the pieces
    `pieces` (df only, None for the base pieces in slot order), through the
    cut entry point if `cut_entry`; raises on anything the kernel does not
    take and on a launch error.  Returns (accelerations, stats)."""
    device = src.device
    if device.type != "cuda":
        raise ValueError(f"no fused Barnes-Hut kernel for device {device}")
    if not 1 <= group_size <= MAX_GROUP_SIZE:
        raise ValueError(f"group_size must be in [1, {MAX_GROUP_SIZE}] (the kernel "
                         f"runs one block per group), got {group_size}")
    _check_kernel_inputs(tree, gstart, gcount, src, bsq, ld, dtype)
    if order is not None and (order.dtype != torch.int32 or order.device != device
                              or order.shape != gcount.shape):
        raise ValueError(f"order: expected int32 {tuple(gcount.shape)} on {device}")
    if pieces is not None and (pieces.dtype != torch.int32 or pieces.device != device
                               or pieces.dim() != 2 or pieces.shape[1] != 3
                               or not pieces.is_contiguous()):
        raise ValueError(f"pieces: expected contiguous int32 (P, 3) on {device}")

    from nbody_tpu_torch.ops import _cuda

    kernels = _cuda.library()
    with torch.cuda.device(device):
        err, out, stats = launch(
            kernels.lib, tree, gstart, gcount, src, bsq, _cuda.stream_handle(device),
            theta=theta, eps2=eps2, leaf_cap=leaf_cap, ld=ld, group_size=group_size,
            frontier_cap=frontier_cap, debug_mode=debug_mode, order=order,
            pieces=pieces, cut_entry=cut_entry,
        )
    if err != 0:
        fcap = _round_cap(frontier_cap)
        smem = kernels.lib.nbody_bh_fused_smem_bytes(fcap, int(dtype == torch.float64))
        kernels.check(err, f"bh_fused kernel ({dtype}, cut {debug_mode}, group_size "
                           f"{group_size}, frontier cap {fcap}: {smem} bytes of shared "
                           "memory per block)")
    return out, stats


def fused_group_forces(
    tree: GridTree,
    gstart: torch.Tensor,
    gcount: torch.Tensor,
    src: torch.Tensor,
    bsq: torch.Tensor,
    *,
    theta: float,
    eps2: float,
    leaf_cap: int,
    ld: int,
    group_size: int,
    frontier_cap: int = FRONTIER_CAP,
    debug_mode: str = "full",
):
    """f32 accelerations (n, 3) in sorted order and stats (G, N_STATS)
    int32 for the groups (gstart, gcount) of the sorted f32 sources `src`
    (n, 4) [x y z G·m] against the f32 dense grid `tree` of depth `ld`,
    with f32 bsq[l] = (border / 2^l)^2.  Groups hold at most `group_size`
    bodies.  Bodies of no group (trimmed groups) get zero acceleration.
    `debug_mode` is a stage cut of ``CUTS`` (zero forces short of
    "full")."""
    check_ld(ld)
    check_debug_mode(debug_mode)
    kw = dict(theta=theta, eps2=eps2, leaf_cap=leaf_cap, ld=ld,
              group_size=group_size, frontier_cap=frontier_cap, debug_mode=debug_mode)
    if src.device.type == "cpu":
        with span("bh.k6.full"):
            return fused_group_forces_reference(tree, gstart, gcount, src, bsq, **kw)
    order = None
    if debug_mode == "full":
        est = price_groups(tree, gstart, gcount, src, bsq, **kw)
        with span("bh.k6.order"):
            order = heavy_first(est, gcount)
    with span("bh.k6.full"):
        out, stats = kernel_forces(torch.float32, tree, gstart, gcount, src, bsq, **kw,
                                   order=order)
    fused_group_forces.launches += 1
    fused_group_forces.evaluations += 1
    return out, stats


def price_groups(tree: GridTree, gstart, gcount, src, bsq, **kw) -> torch.Tensor:
    """K6's pricing pass: the stats (G, N_STATS) of a "full" evaluation
    from one launch of the "pops" cut in slot order, and no forces; on a
    CPU tensor, the plain version's "pops" cut.  `kw` are
    ``fused_group_forces``'s keywords (its `debug_mode` is ignored).  The
    launch counts in ``fused_group_forces.launches``, not in its
    evaluations.  No host sync."""
    check_ld(kw["ld"])
    if src.device.type == "cpu":
        return price_groups_reference(tree, gstart, gcount, src, bsq, **kw)
    with span("bh.k6.price"):
        _, stats = kernel_forces(torch.float32, tree, gstart, gcount, src, bsq,
                                 **{**kw, "debug_mode": "pops"})
    fused_group_forces.launches += 1
    return stats


# At "full" an evaluation is two launches of K6: the "pops" cut that prices
# the groups, then the full kernel in heavy-first order.
fused_group_forces.launches = 0
fused_group_forces.evaluations = 0
fused_group_forces.price = price_groups


def heavy_first(stats: torch.Tensor, gcount: torch.Tensor) -> torch.Tensor:
    """The group slots (int32) in descending order of their pairs, staged
    sources x bodies, ties in slot order.  A block per group leaves the
    card waiting on the heaviest groups when they start last (a dense core
    holds groups of ~9x the mean work); starting them first lets the light
    groups fill the tail."""
    work = stats[:, S_SRC].long() * gcount.long()
    return torch.argsort(work, descending=True, stable=True).to(torch.int32)


# K6's df mode runs a block of DF_THREADS threads, one body each, per piece
# of a group; a group of more bodies is cut into ceil(count / DF_THREADS)
# base pieces of whole warps, so a 1,024-body group spreads over four
# blocks.  Cutting the heavy groups finer still never helped on the card
# (PERF.md, the K6 df findings), so the pieces are the base pieces only.
DF_THREADS = 256


def df_pieces(gcount: torch.Tensor, group_size: int,
              stats: torch.Tensor | None = None) -> torch.Tensor:
    """K6 df's piece table, int32 (P, 3) [slot, first body, end body), on
    gcount's device, built there without a host sync.  Each occupied group
    is cut evenly into ceil(count / DF_THREADS) pieces of whole warps (32
    bodies).  With the pricing pass's `stats` the pieces come heaviest
    first (staged sources x the piece's bodies, ties in slot order), else
    in slot order.  The table has a fixed number of rows for the shapes,
    G x ceil(B / DF_THREADS): rows past the pieces are spare, with end =
    first = 0."""
    device = gcount.device
    gc = gcount.long()
    n_groups = gc.shape[0]
    warps = (gc + 31) // 32
    k = (gc + DF_THREADS - 1) // DF_THREADS
    kmax = -(-int(group_size) // DF_THREADS)
    j = torch.arange(kmax, device=device)
    valid = j[None, :] < k[:, None]
    kk = k.clamp(min=1)[:, None]
    b0 = 32 * ((j[None, :] * warps[:, None]) // kk)
    b1 = torch.minimum(32 * (((j[None, :] + 1) * warps[:, None]) // kk), gc[:, None])
    b0, b1 = torch.where(valid, b0, 0), torch.where(valid, b1, 0)
    slot = torch.arange(n_groups, device=device)[:, None].expand(-1, kmax)
    if stats is None:
        key = valid.long()
    else:
        key = torch.where(valid, stats[:, S_SRC].long()[:, None] * (b1 - b0), -1)
    pick = torch.argsort(key.flatten(), descending=True, stable=True)
    table = torch.stack([slot.flatten()[pick], b0.flatten()[pick], b1.flatten()[pick]], 1)
    return table.to(torch.int32).contiguous()


def df_pricing_pieces(gcount: torch.Tensor) -> torch.Tensor:
    """The pricing pass's piece table: each group's first piece only (the
    box and the traversal are the whole group's, so its stats are too), in
    slot order."""
    gc = gcount.long()
    first = torch.minimum(gc, torch.full_like(gc, DF_THREADS))
    slot = torch.arange(gc.shape[0], device=gc.device)
    return torch.stack([slot, torch.zeros_like(gc), first], 1).to(torch.int32).contiguous()


def df_price(tree: GridTree, gstart, gcount, src, bsq, **kw) -> torch.Tensor:
    """K6 df's pricing launch: the "pops" cut over each group's first
    piece (the box and the traversal are the whole group's, so its stats
    are "full"'s).  `kw` are ``kernel_forces``'s keywords (its
    `debug_mode` is ignored); no host sync."""
    with span("bh.k6.price"):
        _, stats = kernel_forces(torch.float64, tree, gstart, gcount, src, bsq,
                                 **{**kw, "debug_mode": "pops"},
                                 pieces=df_pricing_pieces(gcount))
    return stats


def df_launch_pieces(tree: GridTree, gstart, gcount, src, bsq, **kw):
    """(stats, pieces) of K6 df's production launch on these inputs: the
    pricing launch (``df_price``) prices the groups, and ``df_pieces``
    orders the base pieces heaviest first from its stats.  `kw` are
    ``kernel_forces``'s keywords; no host sync."""
    stats = df_price(tree, gstart, gcount, src, bsq, **kw)
    with span("bh.k6.order"):
        return stats, df_pieces(gcount, kw["group_size"], stats)


def fused_group_forces_reference(
    tree: GridTree,
    gstart: torch.Tensor,
    gcount: torch.Tensor,
    src: torch.Tensor,
    bsq: torch.Tensor,
    *,
    theta: float,
    eps2: float,
    leaf_cap: int,
    ld: int,
    group_size: int = MAX_GROUP_SIZE,
    frontier_cap: int = FRONTIER_CAP,
    debug_mode: str = "full",
):
    """The plain PyTorch version of K6 in both modes: the same decisions in
    the same arithmetic, the same stats.  The MAC is f32, each operation
    rounded on its own, on the f32-rounded centres of mass and bodies; the
    evaluation is in src's dtype (f32, or f64 in the df mode).  It walks
    all groups at once over a tensor of (group, cell) frontier pairs, level
    by level, then evaluates each group's sources in blocks so that memory
    stays bounded.  `group_size` is taken for the kernel's signature; the
    groups' own counts rule.  At a stage cut `debug_mode` short of "full"
    the forces are zero (and the stats too in "none"), as the kernel's."""
    del group_size
    check_debug_mode(debug_mode)
    device, dtype = src.device, src.dtype
    f32 = torch.float32
    n, n_groups = src.shape[0], gstart.shape[0]
    fcap = _round_cap(frontier_cap)
    theta_sq = torch.tensor(_theta_sq(theta), dtype=f32, device=device)
    bsq = bsq.to(f32)
    off = grid_offsets(ld)
    stats = torch.zeros((n_groups, N_STATS), dtype=torch.int64, device=device)
    out = torch.zeros((n, 3), dtype=dtype, device=device)
    live = torch.nonzero(gcount > 0).flatten()
    n_live = live.shape[0]
    if n_live == 0 or debug_mode == "none":
        return out, stats.to(torch.int32)
    gs = gstart[live].long()
    gc = gcount[live].long()

    # group bounding boxes over the live bodies
    slots = torch.arange(int(gc.max()), device=device)
    valid = slots[None, :] < gc[:, None]
    body = src[(gs[:, None] + slots).clamp(max=n - 1), :3]  # (L, B, 3)
    body32 = body.to(f32)
    inf = torch.tensor(float("inf"), dtype=f32, device=device)
    lo = torch.where(valid[..., None], body32, inf).amin(dim=1)
    hi = torch.where(valid[..., None], body32, -inf).amax(dim=1)

    fl = torch.arange(n_live, device=device)  # frontier: live-group index
    fc = torch.zeros(n_live, dtype=torch.int64, device=device)  # cell at level d
    far_parts, near_parts = [], []
    ovf = torch.zeros(n_live, dtype=torch.int64, device=device)
    pops = torch.zeros(n_live, dtype=torch.int64, device=device)
    j8 = torch.arange(8, device=device)
    for d in range(ld):
        terminal = d + 1 >= ld
        pops += torch.bincount(fl, minlength=n_live)
        child = fc[:, None] * 8 + j8  # (P, 8), ascending child order
        c = off[d + 1] + child
        cnt = tree.cnt[c].long()
        com = torch.stack([tree.cx[c], tree.cy[c], tree.cz[c]], dim=-1)  # (P, 8, 3)
        com32 = com.to(f32)
        dd = com32 - torch.minimum(torch.maximum(com32, lo[fl][:, None]), hi[fl][:, None])
        sq = dd * dd
        d2 = sq[..., 0] + sq[..., 1] + sq[..., 2]
        exists = cnt > 0
        far = exists & (theta_sq * d2 > bsq[d + 1])
        near = exists & ~far & ((cnt <= leaf_cap) | terminal)
        opn = exists & ~far & ~near
        g8 = fl[:, None].expand_as(child)
        far_parts.append((g8[far], torch.cat([com[far], tree.gm[c][far][:, None]], 1)))
        near_parts.append((g8[near], tree.start[c][near].long(), cnt[near]))
        # next frontier in (group, Morton) order, cut to the first fcap
        nfl, nfc = g8[opn], child[opn]
        per = torch.bincount(nfl, minlength=n_live)
        ovf = torch.where(per >= fcap, torch.maximum(ovf, per), ovf)
        rank = torch.arange(nfl.shape[0], device=device) - (torch.cumsum(per, 0) - per)[nfl]
        keep = rank < fcap
        fl, fc = nfl[keep], nfc[keep]

    far_g = torch.cat([p[0] for p in far_parts])
    far_src = torch.cat([p[1] for p in far_parts])
    near_g = torch.cat([p[0] for p in near_parts])
    near_start = torch.cat([p[1] for p in near_parts])
    near_cnt = torch.cat([p[2] for p in near_parts])
    n_far = torch.bincount(far_g, minlength=n_live)
    n_near = torch.zeros(n_live, dtype=torch.int64, device=device)
    n_near.index_add_(0, near_g, near_cnt)
    stats[live] = torch.stack([pops, n_far + n_near, n_near, ovf, n_far], dim=1)
    if debug_mode != "full":
        return out, stats.to(torch.int32)

    # every source row of every group: far COMs, then near bodies, grouped
    nb_g = torch.repeat_interleave(near_g, near_cnt)
    first = torch.cumsum(near_cnt, 0) - near_cnt
    nb_idx = (torch.repeat_interleave(near_start - first, near_cnt)
              + torch.arange(nb_g.shape[0], device=device))
    rows = torch.cat([far_src, src[nb_idx]])
    rows = rows[torch.argsort(torch.cat([far_g, nb_g]), stable=True)]
    bounds = [0] + torch.cumsum(n_far + n_near, 0).tolist()
    acc = torch.stack([
        _eval_block(body[li], rows[bounds[li]:bounds[li + 1]], eps2)
        for li in range(n_live)
    ])
    out[(gs[:, None] + slots)[valid]] = acc[valid]
    return out, stats.to(torch.int32)


def price_groups_reference(tree: GridTree, gstart, gcount, src, bsq, **kw) -> torch.Tensor:
    """The plain version's pricing pass: its "pops" cut, the stats of
    "full" and no forces.  `kw` are its keywords (`debug_mode` ignored)."""
    with span("bh.k6.price"):
        return fused_group_forces_reference(tree, gstart, gcount, src, bsq,
                                            **{**kw, "debug_mode": "pops"})[1]


fused_group_forces_reference.price = price_groups_reference


def _eval_block(targets: torch.Tensor, sources: torch.Tensor, eps2: float) -> torch.Tensor:
    """(B, 3) accelerations of `targets` from `sources` (S, 4) [x y z G·m]
    with K1's formula, in source blocks of bounded size."""
    acc = torch.zeros_like(targets)
    step = max(1, _PAIR_BLOCK // max(1, targets.shape[0]))
    for s0 in range(0, sources.shape[0], step):
        s = sources[s0:s0 + step]
        d = s[None, :, :3] - targets[:, None, :]  # (B, S, 3)
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2] + eps2
        inv = torch.rsqrt(r2)
        w = s[None, :, 3] * (inv * inv * inv)
        acc += (w[..., None] * d).sum(dim=1)
    return acc


class FusedInputs(NamedTuple):
    """What K6 and its plain version take for one force evaluation, and the
    permutation back to the input order."""

    perm: torch.Tensor  # (n,) sorted slot -> input index
    tree: GridTree
    gstart: torch.Tensor  # (keep,) int32
    gcount: torch.Tensor  # (keep,) int32
    src: torch.Tensor  # (n, 4) sorted [x y z G·m]
    bsq: torch.Tensor  # (ld + 2,) f32 (border / 2^l)^2
    ld: int
    group_size: int
    trimmed: torch.Tensor  # 0-dim: occupied groups cut by `keep`


def prepare_fused(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    ld: int = 0,
    group_size: int = 1024,
    keep_groups: int = 0,
    border: torch.Tensor | None = None,
) -> FusedInputs:
    """Morton sort, dense grid and Morton groups for `pos`/`mass`
    (``nbody_tpu/ops/bh_fused.py:1272-1327``), in f32, or for f64 bodies
    in f64 (the df mode, ``nbody_tpu/ops/bh_fused_df.py:121-178``); bsq is
    f32 in both, as the MAC is.  The three stages are ``sort_bodies``,
    ``build_grid`` and ``group_inputs`` (``FusedSetup``), sized by
    ``layout_sizing``, which raises CapacityError before any work when the
    layout would not fit.

    On the card the stages replay from CUDA graphs captured, and the budget
    is read, once a layout (``fused_setup``; ``prepare_fused.captures`` and
    ``.replays`` count both), so a layout's later set-ups do not sync.  The
    outputs then live in the graphs' memory and the next set-up of the
    same layout overwrites them: a caller uses them before its next set-up
    and copies what it keeps.  Off the card the stages run eagerly, sized
    anew at every call."""
    ld = ld or auto_ld(pos.shape[0])
    return fused_setup(pos, mass, border, G=G, ld=ld, group_size=group_size,
                       keep_groups=keep_groups).run(pos, mass, border)


def fused_setup(pos, mass, border=None, *, G: float, ld: int, group_size: int,
                keep_groups: int = 0) -> "FusedSetup":
    """The set-up of the layout of `pos`/`mass`: off the card a new
    ``FusedSetup``; on the card the one kept for the layout (its device, n,
    dtypes, whether `border` is given, G, `ld`, `group_size` and
    `keep_groups`), sized and captured under ``bh.setup.capture`` when the
    layout is first seen.  On the card counts the capture in
    ``prepare_fused.captures``, else a replay in ``.replays``."""
    layout = dict(G=G, ld=ld, group_size=group_size, keep_groups=keep_groups)
    if pos.device.type != "cuda":
        return FusedSetup(pos, mass, border, **layout)
    # G enters the graphs as a constant of the sort's multiply
    key = (pos.device, pos.shape[0], pos.dtype, mass.dtype,
           None if border is None else border.dtype, *layout.values())
    setup = _SETUPS.get(key)
    if setup is None:
        with span("bh.setup.capture"):
            setup = _SETUPS[key] = FusedSetup(pos, mass, border, **layout)
            # the capture has synchronized the device, so the oldest layout's
            # graphs are idle and may go
            if len(_SETUPS) > SETUP_GRAPH_LAYOUTS:
                del _SETUPS[next(iter(_SETUPS))]
        prepare_fused.captures += 1
    else:
        prepare_fused.replays += 1
    return setup


prepare_fused.captures = 0
prepare_fused.replays = 0

# layouts whose set-up graphs a process keeps (each holds ~128 B a body on
# the card); a run uses one, and past these the oldest goes
SETUP_GRAPH_LAYOUTS = 4
_SETUPS: dict = {}


def layout_sizing(n: int, group_size: int, ld: int, keep_groups: int, f64: bool,
                  device: torch.device) -> tuple[int, int]:
    """(split level, group slots) of the fused layout of `n` bodies in
    groups of `group_size` on a grid of depth `ld`: the slots are
    `keep_groups` or the budget's margin (``capacity.auto_keep``), with the
    budget read from the free device memory, which the card does once a
    layout, as the reference sizes its pool once at start-up
    (cuda/barnes-hut.cu:886-890).  Raises CapacityError, with its GiB
    numbers, when the predicted residency (doubled for `f64` bodies, as
    ``bh_fused_df.py:146-149``) exceeds the budget."""
    split_level = auto_split_level(n, group_size)
    g_max = group_capacity(n, group_size, split_level, MORTON_DEPTH)
    budget = capacity.budget_bytes(device)
    keep = min(keep_groups or capacity.auto_keep(n, group_size, g_max, budget), g_max)
    est = capacity.estimate_fused_bytes(n, group_size, keep, ld)
    if f64:  # f64 sources and tables: twice the f32 bytes
        est = {k: 2 * v for k, v in est.items()}
    if budget is not None:  # ensure_fits reads a budget of None again
        capacity.ensure_fits(est, f"fused Barnes-Hut at n={n}", budget=budget)
    return split_level, keep


class FusedSetup:
    """The one-shot set-up of one layout, sized once (``layout_sizing``):
    three stages, the sort, the grid and the groups, run in that order.  On
    the card they are CUDA graphs, captured here on one memory pool after
    an eager warm-up on a side stream, as ``torch.cuda.graph`` asks
    (nothing in them syncs: ``torch.segment_reduce`` runs `unsafe`,
    unchecked); a run copies the caller's bodies (and border) into the
    graphs' static inputs and replays them.  Off the card the stages run
    eagerly on the caller's tensors."""

    def __init__(self, pos, mass, border, *, G, ld, group_size, keep_groups):
        self.G, self.ld, self.group_size = G, ld, group_size
        self.split_level, self.keep = layout_sizing(
            pos.shape[0], group_size, ld, keep_groups, pos.dtype == torch.float64,
            pos.device)
        self.graphs = None
        if pos.device.type != "cuda":
            return
        static = torch.contiguous_format
        self.pos, self.mass = pos.clone(memory_format=static), mass.clone(memory_format=static)
        self.border = None if border is None else border.clone(memory_format=static)
        with torch.cuda.device(pos.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for stage in self._STAGES:
                    stage(self)
            torch.cuda.current_stream().wait_stream(side)
            graphs = [torch.cuda.CUDAGraph() for _ in self._STAGES]
            for i, stage in enumerate(self._STAGES):
                with torch.cuda.graph(graphs[i], pool=graphs[0].pool() if i else None):
                    stage(self)
        self.graphs = graphs

    def _sort(self) -> None:
        self.sorted = sort_bodies(self.pos, self.mass, G=self.G, border=self.border)

    def _grid(self) -> None:
        self.tree = build_grid(*self.sorted[1:4], MORTON_DEPTH, self.ld)

    def _groups(self) -> None:
        self.groups = group_inputs(*self.sorted[1:], ld=self.ld, group_size=self.group_size,
                                   split_level=self.split_level, keep=self.keep)

    _STAGES = (_sort, _grid, _groups)

    def stage(self, i: int, pos=None, mass=None, border=None) -> None:
        """Run stage `i` (0 the sort, 1 the grid, 2 the groups); the sort
        takes `pos`, `mass` (and `border`).  On the card the sort first
        copies them into the static inputs, and each stage replays its
        graph."""
        if self.graphs is None:
            if i == 0:
                self.pos, self.mass, self.border = pos, mass, border
            self._STAGES[i](self)
            return
        with torch.cuda.device(self.pos.device):
            if i == 0:
                self.pos.copy_(pos)
                self.mass.copy_(mass)
                if border is not None:
                    self.border.copy_(border)
            self.graphs[i].replay()

    def inputs(self) -> FusedInputs:
        """The last run's outputs (on the card in the graphs' memory)."""
        gstart, gcount, src, bsq, trimmed = self.groups
        return FusedInputs(self.sorted[0], self.tree, gstart, gcount, src, bsq, self.ld,
                           self.group_size, trimmed)

    def run(self, pos, mass, border=None) -> FusedInputs:
        """The layout of `pos`/`mass` (and `border`): the three stages, each
        in its span."""
        for i, name in enumerate(("bh.sort", "bh.grid", "bh.groups")):
            with span(name):
                self.stage(i, pos, mass, border)
        return self.inputs()


def sort_bodies(pos: torch.Tensor, mass: torch.Tensor, *, G: float = constants.BIG_G,
                border: torch.Tensor | None = None):
    """(perm, pos_s, gm_s, keys_s, border): the bodies in Morton order, in
    f32, or f64 for f64 bodies, with G·m."""
    cdt = torch.float64 if pos.dtype == torch.float64 else torch.float32
    perm, keys, border = morton_sort(pos, MORTON_DEPTH, border=border)
    # G rounded to the compute dtype times the masses, as JAX's f32 G * mass
    # (a Python scalar enters the multiply in the tensor's dtype, with no
    # host-to-device copy)
    return perm, pos[perm].to(cdt), mass[perm].to(cdt) * G, keys[perm], border


def group_inputs(pos_s, gm_s, keys_s, border, *, ld: int, group_size: int,
                 split_level: int, keep: int):
    """(gstart, gcount, src, bsq, trimmed): the Morton groups of the sorted
    bodies at `split_level`, packed and cut to `keep` slots (both from
    ``layout_sizing``), K6's source rows and the MAC's f32 bsq.  No host
    sync."""
    n, device = pos_s.shape[0], pos_s.device
    gstart, gcount = group_ranges(keys_s, n, MORTON_DEPTH, group_size, split_level)
    gstart, gcount, _, _, trimmed = compact_groups(gstart, gcount, None, None, keep)
    src = torch.cat([pos_s, gm_s[:, None]], dim=1)
    lev = torch.arange(ld + 2, dtype=torch.float32, device=device)
    bsq = (border.to(torch.float32) / torch.exp2(lev)) ** 2
    return gstart, gcount, src, bsq, trimmed


def barneshut_fused(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    theta: float = constants.THETA,
    ld: int = 0,
    leaf_cap: int = 64,
    group_size: int = 1024,
    keep_groups: int = 0,
    frontier_cap: int = 0,
    return_stats: bool = False,
    border: torch.Tensor | None = None,
    group_forces=fused_group_forces,
):
    """Barnes-Hut accelerations through the fused traversal (ForceFn
    signature), returned in pos's dtype.  Exact (not COM-merged) forces for
    clusters denser than the grid's terminal cells.

    Computes in f32, or for f64 bodies in the df mode (f64 evaluation,
    f32 MAC), which needs a df evaluator: ``fused_group_forces_reference``
    or ``bh_fused_df.fused_group_forces_df`` (the f32 kernel refuses f64;
    ``bh_fused_df.barneshut_fused_df`` is the df entry point).  `border`
    overrides the root-cube size.  `group_forces` is the group evaluator:
    the K6 wrapper (default) or ``fused_group_forces_reference``
    (``--backend torch``, which must not launch the kernel on the card).
    No host sync on the kernel path unless `return_stats`."""
    fi = prepare_fused(pos, mass, G=G, ld=ld, group_size=group_size,
                       keep_groups=keep_groups, border=border)
    acc_s, stats = group_forces(
        fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq, theta=theta,
        eps2=softening_sq, leaf_cap=leaf_cap, ld=fi.ld, group_size=fi.group_size,
        frontier_cap=frontier_cap or FRONTIER_CAP,
    )
    acc = scatter_back(acc_s, fi.perm).to(pos.dtype)
    if return_stats:
        return acc, summarize_stats(stats, fi.trimmed)
    return acc


@spanned("bh.scatter")
def scatter_back(acc_s: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Sorted-order accelerations back to the input order: one indexed copy
    (perm is a bijection, so the writes are disjoint)."""
    acc = torch.empty_like(acc_s)
    acc[perm] = acc_s
    return acc


def summarize_stats(stats: torch.Tensor, trimmed: torch.Tensor) -> dict:
    """The JAX package's stats dict from the per-group lanes, as 0-dim
    int64 tensors (no host sync).  `trimmed` is copied: on the card it
    lives in the set-up graphs' memory, which the next set-up overwrites."""
    s = stats.long()
    return {
        "pops": s[:, S_POPS].sum(),
        "staged_sources": s[:, S_SRC].sum(),
        "near_bodies": s[:, S_NEAR].sum(),
        "frontier_overflow": s[:, S_OVF].max(),
        "trimmed_groups": trimmed.clone(),
        "far_children": s[:, S_FAR].sum(),
    }


@spanned("bh.probe")
def check_fused(
    pos: torch.Tensor,
    mass: torch.Tensor,
    robust: bool = False,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    theta: float = constants.THETA,
    ld: int = 0,
    leaf_cap: int = 64,
    group_size: int = 1024,
    keep_groups: int = 0,
    frontier_cap: int = 0,
    outlier_slots: int = 0,
    group_forces=fused_group_forces,
    rect_forces=None,
):
    """Fail-fast probe for the fused path: the run's own one-shot layout
    (``prepare_fused``; with `robust`, on ``robust_tree``'s box, so an
    outlier-heavy run is checked against the cube it will use) and the
    pricing pass of the run's evaluator `group_forces` (its ``.price``: the
    stats of a full evaluation, no forces).  Raises CapacityError if the
    frontier overflowed or occupied groups were trimmed — the only two
    capacities the path has, read in one host sync; the message prescribes
    the flag value that fits.  The options are ``barneshut_fused``'s (and
    ``barneshut_fused_robust``'s: `rect_forces`, the outliers' rectangle,
    has no capacity and is not run).  Returns the stats dict of
    ``barneshut_fused(..., return_stats=True)``."""
    del rect_forces
    border = None
    if robust:
        t = robust_tree(pos, mass, outlier_slots, ld)
        pos, mass, border, ld = t.rel, t.mass, t.border, t.ld
    fi = prepare_fused(pos, mass, G=G, ld=ld, group_size=group_size,
                       keep_groups=keep_groups, border=border)
    stats = summarize_stats(group_forces.price(
        fi.tree, fi.gstart, fi.gcount, fi.src, fi.bsq, theta=theta, eps2=softening_sq,
        leaf_cap=leaf_cap, ld=fi.ld, group_size=fi.group_size,
        frontier_cap=frontier_cap or FRONTIER_CAP), fi.trimmed)
    with host_sync("probe.stats"):
        fovf, trimmed = torch.stack([stats["frontier_overflow"],
                                     stats["trimmed_groups"]]).tolist()
    fixes = []
    if fovf > 0:
        need = _round_cap(max(fovf + 1, FRONTIER_CAP))
        fixes.append(
            f"frontier overflow (a level needed >= {fovf} octets): pass "
            f"--bh-frontier-cap {need}"
        )
    if trimmed > 0:
        keep = fi.gstart.shape[0]  # the slots the layout was sized to
        fixes.append(
            f"{trimmed} occupied groups trimmed: pass "
            f"--bh-keep-groups {keep + trimmed}"
        )
    if fixes:
        raise capacity.CapacityError("fused Barnes-Hut capacity overflow: "
                                     + "; ".join(fixes))
    return stats


def _median(x: torch.Tensor) -> torch.Tensor:
    """Column medians of `x` (n, d) as ``jnp.median``: the mean of the two
    middle values for even n (``torch.median`` takes the lower one, and
    ``torch.quantile`` refuses more than 16M elements)."""
    n = x.shape[0]
    lo = torch.kthvalue(x, (n + 1) // 2, dim=0).values
    if n % 2:
        return lo
    return (lo + torch.kthvalue(x, n // 2 + 1, dim=0).values) * 0.5


def robust_box(pos: torch.Tensor, outlier_slots: int = 0):
    """The robust hybrid's box (``nbody_tpu/ops/bh_fused.py:1500-1508``),
    in f32 whatever pos's dtype: (centre (3,), the coordinate-wise median;
    border (0-dim), 2 * the (K+1)-th largest L-inf distance from it *
    1.0001; out_idx (K,), the K farthest bodies), with K =
    `outlier_slots` or max(128, n // 512), at most n - 1."""
    n = pos.shape[0]
    k = min(int(outlier_slots) or max(128, n // 512), n - 1)
    pos32 = pos.to(torch.float32)
    center = _median(pos32)
    d = (pos32 - center).abs().amax(dim=1)
    vals, idx = torch.topk(d, k + 1)
    return center, 2.0 * vals[k] * 1.0001, idx[:k]


class RobustTree(NamedTuple):
    """The robust hybrid's tree input (``nbody_tpu/ops/bh_fused.py:
    1500-1512``)."""

    targets: torch.Tensor  # (n, 3) the bodies, f32 (or f64 in the df mode)
    rel: torch.Tensor  # (n, 3) targets less the box's centre
    mass: torch.Tensor  # (n,) the masses, the outliers' zeroed
    border: torch.Tensor  # 0-dim, the box's side
    out_idx: torch.Tensor  # (K,) the outliers
    ld: int  # the grid's depth


def robust_tree(pos: torch.Tensor, mass: torch.Tensor, outlier_slots: int = 0,
                ld: int = 0) -> RobustTree:
    """``robust_box``, the bodies shifted into it and the outliers
    zero-massed; the depth is `ld`, or min(8, auto_ld + 2)."""
    center, border, out_idx = robust_box(pos, outlier_slots)
    targets = pos if pos.dtype == torch.float64 else pos.to(torch.float32)
    return RobustTree(targets, targets - center.to(targets.dtype),
                      mass.index_fill(0, out_idx, 0.0), border, out_idx,
                      ld or min(MAX_LD, auto_ld(pos.shape[0]) + 2))


def outlier_rect(targets, src, mass_src, *, G: float, softening_sq: float, rect_forces):
    """The robust hybrid's exact (M, K) rectangle of the outliers' pull
    (``bh_fused.py:1425-1444``) through `rect_forces`: K1
    (``cuda_rect_accelerations``) in f32, K4 in f64, or their plain
    version.  Both are the displacement form, which stays exact at outlier
    coordinates where the expanded |r|^2 form loses ~4 digits."""
    return rect_forces(targets, src.contiguous(), mass_src.contiguous(), G=G,
                       softening_sq=softening_sq)


def barneshut_fused_robust(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    outlier_slots: int = 0,
    return_stats: bool = False,
    rect_forces=cuda_rect_accelerations,
    **kw,
):
    """Outlier-robust fused Barnes-Hut, the exact hybrid of
    ``nbody_tpu/ops/bh_fused.py:1447-1523`` (ForceFn signature).

    A few escapers inflate the root cube until one terminal cell holds
    nearly every body, and the near field degenerates to ~O(N^2).  Here:
    the root cube is sized by the (K+1)-th largest L-inf distance from the
    median (``robust_box``), so at most K bodies fall outside; those K ride
    the tree zero-massed (clipped into edge cells, they move no centre of
    mass, and as targets they are still exact: their group boxes use true
    positions); their pull as sources is added back by one exact (N, K)
    rectangle (``outlier_rect``).  The grid deepens to ld = min(8, auto_ld
    + 2) unless `ld` is given.

    f32 bodies take the f32 tree; f64 bodies the df tree (with a df
    evaluator as `group_forces`), with the box in f32 as in JAX
    (``bh_fused_df.py:226-273``).  `rect_forces` is the rectangle's
    function: K1's wrapper by default, K4's in f64
    (``bh_fused_df.barneshut_fused_robust_df``), or
    ``rect_accelerations_reference`` (``--backend torch``).  The other
    options are ``barneshut_fused``'s."""
    t = robust_tree(pos, mass, outlier_slots, kw.pop("ld", 0))
    res = barneshut_fused(t.rel, t.mass, G=G, softening_sq=softening_sq, ld=t.ld,
                          border=t.border, return_stats=return_stats, **kw)
    acc = res[0] if return_stats else res
    side = outlier_rect(t.targets, t.targets[t.out_idx],
                        mass[t.out_idx].to(t.targets.dtype), G=G,
                        softening_sq=softening_sq, rect_forces=rect_forces)
    acc = acc + side.to(acc.dtype)
    return (acc, res[1]) if return_stats else acc


def state_from_numpy(tree_fields, gstart, gcount, device=None):
    """(GridTree, gstart, gcount) as the port's tensors, from numpy arrays
    such as the JAX package's ``GridTree`` fields (a mapping or a
    NamedTuple) and its ``group_bodies``/``compact_groups`` outputs."""
    if hasattr(tree_fields, "_asdict"):
        tree_fields = tree_fields._asdict()
    tree = GridTree.from_numpy(device=device, **{k: tree_fields[k] for k in GridTree._fields})

    def i32(a):
        return torch.as_tensor(np.array(a), device=device).to(torch.int32).contiguous()

    return tree, i32(gstart), i32(gcount)
