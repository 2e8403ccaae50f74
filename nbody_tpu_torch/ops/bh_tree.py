"""Level-array octree built from sorted Morton keys — counterpart of
``nbody_tpu/ops/bh_tree.py`` (``TreeLevel``, ``build_tree``).

For each level d the node holding body b is the 3d-bit prefix of b's
Morton key.  With bodies sorted by key every node is a contiguous run of
bodies, so per level:

  node ids     = prefix-change cumsum
  node mass    = sum of m over the node's bodies
  node COM     = sum of m·p over the mass
  child links  = the next level's node ids at the node's first and last body

The float sums must be deterministic on the card, since the tree decides
what the traversal opens: CUDA's ``index_add_`` on floats uses atomics.
So the terminal level is ``torch.segment_reduce`` over the runs' lengths
(as ``ops/bh_grid.py``) and every coarser level sums its <= 8 children by
a 3-pass segmented scan, where JAX segment-sums the bodies at every level;
the two agree to rounding.
Counts and first bodies are the runs' boundaries, from a binary search.

Per-level node capacity is min(8^d, N); empty slots hold count 0,
start 0 and child_count 0, as in JAX.

``levels_from_numpy`` carries the JAX package's levels (as numpy arrays)
across, so that the tests can feed both traversals one tree.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TreeLevel(NamedTuple):
    """Nodes of one octree level (padded to a static capacity K).

    com:         (K, 3) centre of mass
    mass:        (K,)   total mass
    count:       (K,)   int32 number of bodies in the node (0 = padding)
    start:       (K,)   int32 first body index (sorted order)
    child_start: (K,)   int32 index of the first child in the next level
    child_count: (K,)   int32 number of children (0 for the last level)
    """

    com: torch.Tensor
    mass: torch.Tensor
    count: torch.Tensor
    start: torch.Tensor
    child_start: torch.Tensor
    child_count: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.mass.shape[0]


def _level_capacity(n: int, depth_level: int) -> int:
    return int(min(8**depth_level, n)) if depth_level > 0 else 1


def build_tree(
    pos_sorted: torch.Tensor,
    mass_sorted: torch.Tensor,
    keys_sorted: torch.Tensor,
    depth: int,
) -> list[TreeLevel]:
    """All levels 0..depth from Morton-sorted bodies, root first, in the
    bodies' dtype.  No host sync."""
    n = pos_sorted.shape[0]
    dev = pos_sorted.device
    wm = torch.cat([mass_sorted[:, None] * pos_sorted, mass_sorted[:, None]], dim=1)

    node_ids = []
    for d in range(depth + 1):
        if d == 0:
            nid = torch.zeros(n, dtype=torch.int64, device=dev)
        else:
            prefix = keys_sorted >> (3 * (depth - d))
            newseg = torch.ones(n, dtype=torch.int64, device=dev)
            newseg[1:] = (prefix[1:] != prefix[:-1]).long()
            nid = torch.cumsum(newseg, 0) - 1
        node_ids.append(nid)

    # counts, first bodies and child links, level by level
    cnts, starts, links = [], [], []
    for d in range(depth + 1):
        # node ids count up from 0 along the sorted bodies, so each node's
        # run is found by a binary search (no atomics)
        bounds = torch.searchsorted(
            node_ids[d], torch.arange(_level_capacity(n, d) + 1, device=dev))
        cnt = bounds[1:] - bounds[:-1]
        start = torch.where(cnt > 0, bounds[:-1], 0)
        if d < depth:
            child_nid = node_ids[d + 1]
            child_start = child_nid[start]
            child_end_body = torch.where(cnt > 0, start + cnt - 1, 0)
            child_count = torch.where(cnt > 0, child_nid[child_end_body] - child_start + 1, 0)
        else:
            child_start = child_count = torch.zeros_like(cnt)
        cnts.append(cnt)
        starts.append(start)
        links.append((child_start, child_count))

    # [m·x, m·y, m·z, m] per node: the terminal level is one segmented sum
    # over the bodies' runs (nodes are consecutive runs in sorted order,
    # numbered from 0); each coarser level sums its <= 8 children, which are
    # consecutive rows of the next level: a segmented scan with strides 1,
    # 2 and 4 leaves each parent's total at its last child.  No atomics, so
    # the sums are deterministic.  (CUDA's segment_reduce loops over each
    # segment in one thread, too slow for the coarse levels' long runs.)
    # The scan shifts rows by slicing and reads the totals with
    # index_select: on the card, advanced indexing of (1M, 4) float rows
    # launches a row gather that was the costliest kernel of the tree.
    sums = [None] * (depth + 1)
    sums[depth] = torch.segment_reduce(wm, "sum", lengths=cnts[depth], axis=0, unsafe=True)
    for d in range(depth - 1, -1, -1):
        child_start, child_count = links[d]
        # each child slot's parent; empty slots (after the real nodes) add 0
        parent = node_ids[d][starts[d + 1]]
        scan = sums[d + 1]
        for k in (1, 2, 4):
            same = (parent[k:] == parent[:-k])[:, None]
            scan = torch.cat([scan[:k], scan[k:] + torch.where(same, scan[:-k], 0.0)])
        last = (child_start + child_count - 1).clamp_min(0)
        sums[d] = torch.where((child_count > 0)[:, None], scan.index_select(0, last), 0.0)

    levels = []
    for d in range(depth + 1):
        m = sums[d][:, 3]
        com = sums[d][:, :3] / torch.clamp_min(m, 1e-30)[:, None]
        child_start, child_count = links[d]
        levels.append(TreeLevel(
            com=com.contiguous(),
            mass=m.contiguous(),
            count=cnts[d].to(torch.int32),
            start=starts[d].to(torch.int32),
            child_start=child_start.to(torch.int32),
            child_count=child_count.to(torch.int32),
        ))
    return levels


def levels_from_numpy(levels, device=None) -> list[TreeLevel]:
    """The port's levels from levels whose fields are arrays (such as the
    JAX package's ``TreeLevel``s): floats keep their dtype, the rest
    become int32."""
    out = []
    for lvl in levels:
        fields = {}
        for name in TreeLevel._fields:
            a = np.array(getattr(lvl, name))  # a writable copy
            t = torch.as_tensor(a, device=device)
            if not t.is_floating_point():
                t = t.to(torch.int32)
            fields[name] = t.contiguous()
        out.append(TreeLevel(**fields))
    return out
