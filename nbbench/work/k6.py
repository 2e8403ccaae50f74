"""The interactions a fused Barnes-Hut evaluation needs (computed, not
measured): for every group of the one-shot layout at the configuration's
depth `ld` and group size, its bodies times its sources, where its sources
are the far cells that the theta group MAC accepts and the bodies of its
near cells, classified by the plain reference (``reference.classify``).
Padding is not counted.  The count is the work of the input the job starts
from; the positions a job's later evaluations see move a small part of a
cell, and the count of the input stands for theirs.  The persistent layout
takes the same count: the layout is a way to do the work, not the work."""

from __future__ import annotations

import torch

from nbbench import reference

FLOPS_PER_INTERACTION = 19  # the pair term of work/allpairs.py


def interactions(config: dict, pos: torch.Tensor, mass: torch.Tensor) -> int:
    """Bodies x sources summed over the groups, for bodies `pos` (n, 3) and
    `mass` (n,) at the configuration's theta, ld, group_size and leaf_cap,
    in f32 (the MAC's precision)."""
    ld = config["ld"]
    _, src, tables, gstart, gcount, bsq = reference.oneshot_layout(
        pos.float(), mass.float(), G=config["G"], ld=ld, group_size=config["group_size"])
    live, _, _, (n_far, n_near) = reference.classify(
        tables, gstart, gcount, src, bsq, theta=config["theta"],
        leaf_cap=config["leaf_cap"], ld=ld)
    return int((gcount[live] * (n_far + n_near)).sum())
