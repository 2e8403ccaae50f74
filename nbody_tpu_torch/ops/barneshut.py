"""Barnes-Hut force assembly: Morton sort -> level tree -> group traversal
-> dense group x interaction-list evaluation — counterpart of
``nbody_tpu/ops/barneshut.py``.

The list-based path (``barneshut_accelerations``): bodies are Morton
sorted, the level tree is built (``ops/bh_tree.py``), bodies are cut into
cell-aligned groups, each group's traversal (``ops/bh_traverse_flat.py``
or ``ops/bh_traverse.py``) writes its interaction list of far centres of
mass and exact near bodies, and the evaluator computes every group slot
against its list.  The evaluator is kernel K7, ``csrc/group_lists.cu``,
wrapped in ``ops/cuda_lists.py`` (``eval_lists`` in f32,
``eval_lists_f64`` in fp64) beside its plain version
``eval_lists_reference``, the port of JAX's ``_eval_lists_jnp``.  A
body's own list entry adds exactly zero (zero displacement), the
reference's self-exclusion (serial/barnes-hut.c:411) without a mask.
The groups follow ``ops/morton.py``'s group rule.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from nbody_tpu_torch.core import capacity, constants
from nbody_tpu_torch.diag.timing import host_sync, spanned
from nbody_tpu_torch.ops import cuda_lists
from nbody_tpu_torch.ops.bh_traverse import TraverseStats, traverse
from nbody_tpu_torch.ops.bh_traverse_flat import traverse_flat
from nbody_tpu_torch.ops.bh_tree import build_tree
from nbody_tpu_torch.ops.morton import group_bodies, morton_sort

TRAVERSALS = ("flat", "padded")
_FAR = 1.0e18  # empty-group sentinel box: far away, so the root is accepted at once


class ResolutionError(RuntimeError):
    """A cluster denser than the terminal Morton resolution was COM-merged;
    forces for those bodies are approximate beyond the theta contract."""


class BHStats(NamedTuple):
    traverse: TraverseStats
    list_capacity: int
    frontier_capacity: int  # 0 for the flat traversal: it reports EXCESS
    range_capacity: int  # 0 for the flat traversal: it reports EXCESS

    def overflowed(self) -> bool:
        return bool(
            int(self.traverse.max_list_needed) > self.list_capacity
            or int(self.traverse.max_frontier_needed) > self.frontier_capacity
            or int(self.traverse.max_ranges_needed) > self.range_capacity
        )


def effective_depth(n: int, depth: int, leaf_cap: int, group_size: int) -> int:
    """Tree depth: the requested depth (<= 10 for int32 Morton keys) with a
    floor of split_level + 3.  Not pruned to the uniform-occupancy
    estimate: clustered inputs put thousands of bodies in cells that a
    uniform model calls empty."""
    del leaf_cap
    sl = max(0, math.ceil(math.log(max(n / group_size, 1.0), 8)))
    return max(3, sl + 3, min(depth, 10))


def auto_layout(n: int, group_size: int, leaf_cap: int) -> tuple[int, int, int]:
    """(group_size, split_level, leaf_cap) for N bodies: the split level
    where cells hold <= 2048 bodies and groups sized to the cell occupancy
    (256..2048, a multiple of 256), so chunks are whole cells; leaf_cap
    tracks the mean occupancy two levels below the split (16..32)."""
    if group_size == 0:
        sl = max(0, math.ceil(math.log(max(n / 2048.0, 1.0), 8)))
        occ = -(-n // (8**sl))
        group_size = int(min(2048, max(256, -(-occ // 256) * 256)))
    else:
        sl = max(0, math.ceil(math.log(max(n / group_size, 1.0), 8)))
    if leaf_cap == 0:
        occ = n / (8 ** (sl + 2))
        leaf_cap = int(min(32, max(16, 2 * occ)))
    return group_size, sl, leaf_cap


def _prepare(pos: torch.Tensor, mass: torch.Tensor, depth: int, group_size: int,
             split_level: int):
    """Morton sort, the level tree, and cell-aligned groups with their
    boxes.  Groups never cross a split-level cell, so a group's box stays
    inside one cell (a chunk straddling the root's centre plane would span
    the domain and its traversal would degenerate toward O(N)).

    Returns (n, perm, levels, border, pos_s, mass_s, group_idx (G, B),
    group_valid (G, B), pg (G, B, 3), lo (G, 3), hi (G, 3)); pad slots
    repeat the group's first body, empty groups get the _FAR box."""
    n = pos.shape[0]
    b = group_size
    perm, keys, border = morton_sort(pos, depth)
    pos_s, mass_s, keys_s = pos[perm], mass[perm], keys[perm]
    levels = build_tree(pos_s, mass_s, keys_s, depth)
    _, gcount, group_idx, group_valid = group_bodies(keys_s, n, depth, b, split_level)
    pg = pos_s[group_idx]
    empty = (gcount == 0)[:, None]
    far = torch.tensor(_FAR, dtype=pg.dtype, device=pg.device)
    lo = torch.where(empty, far, pg.amin(dim=1))
    hi = torch.where(empty, far, pg.amax(dim=1))
    return n, perm, levels, border, pos_s, mass_s, group_idx, group_valid, pg, lo, hi


def default_group_forces(dtype: torch.dtype):
    """K7's wrapper for `dtype`: ``eval_lists`` (f32) or ``eval_lists_f64``."""
    return cuda_lists.eval_lists_f64 if dtype == torch.float64 else cuda_lists.eval_lists


def list_layout(n: int, depth: int, group_size: int, leaf_cap: int):
    """(group_size, split_level, leaf_cap, depth) of the list path for N
    bodies, as barneshut_accelerations resolves its 0 = auto knobs."""
    group_size, split_level, leaf_cap = auto_layout(n, group_size, leaf_cap)
    depth = max(effective_depth(n, depth, leaf_cap, group_size), split_level + 3)
    return group_size, split_level, leaf_cap, depth


def traverse_groups(levels, border, pos_sorted, gm_sorted, lo, hi, *, G, theta,
                    leaf_cap, frontier_size, range_size, list_size, traversal):
    """The groups' interaction lists: (lists (G, M, 4), lengths (G,) int32,
    TraverseStats) from the flat or the padded traversal."""
    dtype = pos_sorted.dtype
    if traversal == "flat":
        return traverse_flat(levels, border.to(dtype), lo, hi, pos_sorted, gm_sorted,
                             G_const=G, theta=theta, leaf_cap=leaf_cap,
                             list_size=list_size)
    if traversal == "padded":
        return traverse(levels, border.to(dtype), lo, hi, pos_sorted, gm_sorted,
                        G_const=G, theta=theta, leaf_cap=leaf_cap,
                        frontier_size=frontier_size, range_size=range_size,
                        list_size=list_size)
    raise ValueError(f"traversal must be one of {TRAVERSALS}, got {traversal!r}")


class GroupLists(NamedTuple):
    """K7's inputs for one evaluation of the list path, and the way back."""

    perm: torch.Tensor  # (n,) sorted slot -> input index
    group_idx: torch.Tensor  # (G, B) sorted body of each slot
    group_valid: torch.Tensor  # (G, B) real slots (the rest are pads)
    pg: torch.Tensor  # (G, B, 3) slot positions
    lists: torch.Tensor  # (G, M, 4) rows [x y z G·m]
    lengths: torch.Tensor  # (G,) int32
    stats: TraverseStats


def group_lists(pos, mass, *, G: float = constants.BIG_G,
                theta: float = constants.THETA, depth: int = 9, group_size: int = 0,
                leaf_cap: int = 0, frontier_size: int = 1024, range_size: int = 1024,
                list_size: int = 16384, traversal: str = "flat") -> GroupLists:
    """Sort, tree, groups and traversal of barneshut_accelerations: what
    its evaluator (K7) takes.  The 0 = auto knobs resolve as in JAX."""
    group_size, split_level, leaf_cap, depth = list_layout(
        pos.shape[0], depth, group_size, leaf_cap)
    (_, perm, levels, border, pos_s, mass_s, group_idx, group_valid,
     pg, lo, hi) = _prepare(pos, mass, depth, group_size, split_level)
    # G rounded to the dtype times the masses, as JAX's asarray(G, dtype) * m
    lists, lengths, tstats = traverse_groups(
        levels, border, pos_s, mass_s * G, lo, hi, G=G, theta=theta, leaf_cap=leaf_cap,
        frontier_size=frontier_size, range_size=range_size, list_size=list_size,
        traversal=traversal)
    return GroupLists(perm, group_idx, group_valid, pg, lists, lengths, tstats)


def scatter_groups(acc_g: torch.Tensor, group_idx: torch.Tensor,
                   group_valid: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """(group, slot) accelerations back to the input order: real slots to
    their sorted bodies (pad slots to a sentinel row n that is dropped),
    then through the inverse of the Morton permutation."""
    n = perm.shape[0]
    dest = torch.where(group_valid, group_idx.long(), n).reshape(-1)
    acc_s = torch.zeros((n + 1, 3), dtype=acc_g.dtype, device=acc_g.device)
    acc_s[dest] = acc_g.reshape(-1, 3)
    acc = torch.empty((n, 3), dtype=acc_g.dtype, device=acc_g.device)
    acc[perm] = acc_s[:n]
    return acc


def barneshut_accelerations(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    theta: float = constants.THETA,
    depth: int = 9,
    group_size: int = 0,
    leaf_cap: int = 0,
    frontier_size: int = 1024,
    range_size: int = 1024,
    list_size: int = 16384,
    traversal: str = "flat",
    return_stats: bool = False,
    group_forces=None,
):
    """Barnes-Hut accelerations through the list-based path (ForceFn
    signature), in pos's dtype.  `traversal` is "flat" or "padded";
    `frontier_size` and `range_size` are the padded traversal's.
    `group_forces` is the list evaluator: K7's wrapper for pos's dtype
    when None, or ``cuda_lists.eval_lists_reference`` (``--backend torch``).

    Capacities are static; if a run exceeds them the stats (ask with
    return_stats=True) report the sizes needed, and check_capacities()
    turns that into a fail-fast probe.  No host sync unless
    `return_stats` is read."""
    if group_forces is None:
        group_forces = default_group_forces(pos.dtype)
    gl = group_lists(pos, mass, G=G, theta=theta, depth=depth, group_size=group_size,
                     leaf_cap=leaf_cap, frontier_size=frontier_size,
                     range_size=range_size, list_size=list_size, traversal=traversal)
    acc_g = group_forces(gl.pg, gl.lists, gl.lengths, eps2=softening_sq)
    acc = scatter_groups(acc_g.to(pos.dtype), gl.group_idx, gl.group_valid, gl.perm)
    if return_stats:
        flat = traversal == "flat"
        return acc, BHStats(traverse=gl.stats, list_capacity=list_size,
                            frontier_capacity=0 if flat else frontier_size,
                            range_capacity=0 if flat else range_size)
    return acc


@spanned("bh.probe")
def check_capacities(pos, mass, *, strict_resolution: bool = True, **kw) -> BHStats:
    """One force evaluation that fails fast: CapacityError if a static
    capacity overflowed (the reference's node-pool exhaustion abort,
    openmp/barnes-hut.c:158-160), naming the setting that fits; with
    strict_resolution, ResolutionError if over-full terminal cells were
    COM-merged (the reference resolves clusters exactly)."""
    _, stats = barneshut_accelerations(pos, mass, return_stats=True, **kw)
    t = stats.traverse
    with host_sync("probe.stats"):
        need_list = int(t.max_list_needed)
    with host_sync("probe.stats"):
        need_f = int(t.max_frontier_needed)
    with host_sync("probe.stats"):
        need_r = int(t.max_ranges_needed)
    fixes = []
    if need_list > stats.list_capacity:
        fixes.append(f"need list={need_list} (have {stats.list_capacity}): pass "
                     f"--bh-list-size {need_list} (list_size={need_list})")
    if kw.get("traversal", "flat") == "flat":
        if need_f > 0:
            fixes.append(f"a flat frontier level is {need_f} entries over its static "
                         "capacity (default_flat_sizes; no flag sets it)")
        if need_r > 0:
            fixes.append(f"the flat near-field range or body store is {need_r} over "
                         "its static capacity (no flag sets it)")
    else:
        if need_f > stats.frontier_capacity:
            fixes.append(f"need frontier={need_f} (have {stats.frontier_capacity}): "
                         f"pass frontier_size={need_f} (no CLI flag)")
        if need_r > stats.range_capacity:
            fixes.append(f"need ranges={need_r} (have {stats.range_capacity}): pass "
                         f"range_size={need_r} (no CLI flag)")
    if fixes:
        raise capacity.CapacityError("Barnes-Hut capacity overflow: " + "; ".join(fixes))
    with host_sync("probe.stats"):
        term = int(t.terminal_com_bodies)
    if strict_resolution and term > 0:
        raise ResolutionError(
            f"Barnes-Hut terminal-resolution residual: up to {term} bodies per "
            "group were COM-merged in over-full terminal cells (cluster denser "
            "than the terminal Morton resolution); results are approximate "
            "beyond theta for those bodies")
    return stats
