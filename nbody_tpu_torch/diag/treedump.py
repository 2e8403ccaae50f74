"""Octree structure dumps — counterpart of ``nbody_tpu/diag/treedump.py``.

Debug-visibility parity with the reference's pretty-printers
(common/bh_support_functions.c:1-53 print_tree / print_tree_indented):
per-level statistics of the level-array octree (``ops/bh_tree.py``) and
an indented subtree walk reconstructed from its child links.  Numpy over
the levels' tensors, read back to the host.
"""

from __future__ import annotations

import io

import numpy as np

from nbody_tpu_torch.ops.bh_tree import TreeLevel


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def level_summary(levels: list[TreeLevel]) -> str:
    """One line per level: node count, body coverage, occupancy stats."""
    out = []
    for d, lvl in enumerate(levels):
        cnt = _np(lvl.count)
        real = cnt > 0
        n_nodes = int(real.sum())
        out.append(
            f"level {d}: {n_nodes} nodes (cap {lvl.capacity}), "
            f"bodies {int(cnt.sum())}, "
            f"occupancy min/mean/max = "
            f"{int(cnt[real].min()) if n_nodes else 0}/"
            f"{float(cnt[real].mean()) if n_nodes else 0:.1f}/"
            f"{int(cnt[real].max()) if n_nodes else 0}"
        )
    return "\n".join(out)


def print_tree_indented(
    levels: list[TreeLevel],
    node: int = 0,
    level: int = 0,
    max_depth: int = 3,
    max_children: int = 8,
    _out: io.TextIOBase | None = None,
) -> str:
    """Indented subtree dump (the analog of
    common/bh_support_functions.c:33-53), truncated to `max_depth` levels
    and `max_children` children a node."""
    buf = _out or io.StringIO()
    lvl = levels[level]
    com = _np(lvl.com[node])
    count = int(lvl.count[node])
    buf.write(
        f"{'  ' * level}[{level}:{node}] n={count} "
        f"m={float(lvl.mass[node]):.4g} "
        f"com=({com[0]:.3g}, {com[1]:.3g}, {com[2]:.3g})\n"
    )
    if level < len(levels) - 1 and level < max_depth and count > 1:
        start = int(lvl.child_start[node])
        n_children = int(lvl.child_count[node])
        for k in range(min(n_children, max_children)):
            print_tree_indented(levels, start + k, level + 1, max_depth, max_children, buf)
        if n_children > max_children:
            buf.write("  " * (level + 1) + f"... {n_children - max_children} more\n")
    if _out is None:
        return buf.getvalue()
    return ""
