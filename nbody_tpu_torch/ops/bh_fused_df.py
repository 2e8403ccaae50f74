"""fp64 fused Barnes-Hut — counterpart of ``nbody_tpu/ops/bh_fused_df.py``.

The reference's Barnes-Hut is ``double`` throughout
(serial/barnes-hut.c:101-434), and ``--dtype f64 --algo barnes-hut``
takes this path.  It runs kernel K6 in its df mode
(``nbody_tpu_torch/csrc/bh_fused.cu``, ``nbody_bh_fused_f64``), the
counterpart of the Pallas ``_fused_kernel`` with ``df=True``:

* sorting, grouping and the grid are the f32 path's
  (``bh_fused.prepare_fused`` on f64 bodies), with the grid's centre-of-
  mass and G·m tables summed in f64;
* the MAC classifies on the f32-rounded tables and bodies with f32 bsq
  and θ², the decision rule of the JAX df kernel
  (``nbody_tpu/ops/bh_fused.py:256-259``), so it opens and accepts the
  same cells as the f32 path on the same tables;
* far sources are the f64 centres of mass and G·m, near sources the f64
  sorted bodies, and every pair is evaluated in fp64.

The TPU kernel reaches fp64 grade with double-float f32 pairs; Hopper has
fp64 units, so K6's df mode is native fp64.

* ``barneshut_fused_df`` — the entry point (ForceFn signature), f64 out.
* ``barneshut_fused_robust_df`` — the exact outlier hybrid in fp64
  (``bh_fused_df.py:226-273``): the box in f32, the tree through K6's df
  mode, the outliers' rectangle through K4.
* ``fused_group_forces_df`` — the K6 df wrapper: a CPU tensor goes to
  the plain version, a CUDA tensor launches the kernel or raises.  At
  "full" an evaluation is two launches: the "pops" cut prices the groups,
  then the full kernel runs the groups' pieces heaviest first
  (``bh_fused.df_launch_pieces``).
  ``fused_group_forces_df.launches`` counts kernel launches,
  ``fused_group_forces_df.evaluations`` the evaluations;
  ``fused_group_forces_df.price`` (``price_groups_df``) is the pricing
  launch alone, the start-up probe's.
* ``fused_group_forces_df_reference`` — the plain version: K6's plain
  version, which takes the df mode from f64 sources (f32 MAC, fp64
  evaluation, the same stats).
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.core import constants
from nbody_tpu_torch.diag.timing import span
from nbody_tpu_torch.ops.bh_fused import (
    FRONTIER_CAP,
    barneshut_fused,
    barneshut_fused_robust,
    check_debug_mode,
    check_ld,
    df_launch_pieces,
    df_price,
    fused_group_forces_reference,
    kernel_forces,
    price_groups_reference,
)
from nbody_tpu_torch.ops.bh_grid import GridTree
from nbody_tpu_torch.ops.cuda_fp64 import cuda_rect_accelerations_f64

fused_group_forces_df_reference = fused_group_forces_reference


def fused_group_forces_df(
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
    """fp64 accelerations (n, 3) in sorted order and stats (G, N_STATS)
    int32, as ``bh_fused.fused_group_forces``, from f64 tables `tree` and
    f64 sources `src` (n, 4) [x y z G·m]; bsq stays f32 (the MAC is f32).
    `debug_mode` is a stage cut of ``bh_fused.CUTS`` (short of "full" one
    launch over the base pieces in slot order)."""
    check_ld(ld)
    check_debug_mode(debug_mode)
    kw = dict(theta=theta, eps2=eps2, leaf_cap=leaf_cap, ld=ld,
              group_size=group_size, frontier_cap=frontier_cap, debug_mode=debug_mode)
    if src.device.type == "cpu":
        with span("bh.k6.full"):
            return fused_group_forces_df_reference(tree, gstart, gcount, src, bsq, **kw)
    pieces = None
    if debug_mode == "full":
        _, pieces = df_launch_pieces(tree, gstart, gcount, src, bsq, **kw)
        fused_group_forces_df.launches += 1
    with span("bh.k6.full"):
        out, stats = kernel_forces(torch.float64, tree, gstart, gcount, src, bsq, **kw,
                                   pieces=pieces)
    fused_group_forces_df.launches += 1
    fused_group_forces_df.evaluations += 1
    return out, stats


def price_groups_df(tree: GridTree, gstart, gcount, src, bsq, **kw) -> torch.Tensor:
    """K6 df's pricing pass: the stats (G, N_STATS) of a "full" evaluation
    from its pricing launch (``bh_fused.df_price``), and no forces; on a
    CPU tensor, the plain version's "pops" cut.  `kw` are
    ``fused_group_forces_df``'s keywords (its `debug_mode` is ignored).
    The launch counts in ``fused_group_forces_df.launches``, not in its
    evaluations.  No host sync."""
    check_ld(kw["ld"])
    if src.device.type == "cpu":
        return price_groups_reference(tree, gstart, gcount, src, bsq, **kw)
    stats = df_price(tree, gstart, gcount, src, bsq, **kw)
    fused_group_forces_df.launches += 1
    return stats


# At "full" an evaluation is two launches of K6 df: the "pops" cut that
# prices the groups, then the full kernel over the pieces, heaviest first.
fused_group_forces_df.launches = 0
fused_group_forces_df.evaluations = 0
fused_group_forces_df.price = price_groups_df


def barneshut_fused_df(
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
    group_forces=fused_group_forces_df,
):
    """fp64 Barnes-Hut accelerations (ForceFn signature), returned in f64
    whatever pos's dtype.  `group_forces` is the group evaluator: the K6 df
    wrapper (default) or ``fused_group_forces_df_reference``
    (``--backend torch``).  The options are ``bh_fused.barneshut_fused``'s."""
    return barneshut_fused(
        pos.to(torch.float64), mass.to(torch.float64), G=G, softening_sq=softening_sq,
        theta=theta, ld=ld, leaf_cap=leaf_cap, group_size=group_size,
        keep_groups=keep_groups, frontier_cap=frontier_cap, return_stats=return_stats,
        border=border, group_forces=group_forces,
    )


def barneshut_fused_robust_df(
    pos: torch.Tensor,
    mass: torch.Tensor,
    *,
    G: float = constants.BIG_G,
    softening_sq: float = constants.SOFTENING_SQ,
    outlier_slots: int = 0,
    return_stats: bool = False,
    group_forces=fused_group_forces_df,
    rect_forces=cuda_rect_accelerations_f64,
    **kw,
):
    """Outlier-robust fp64 Barnes-Hut (ForceFn signature), f64 out: the
    hybrid of ``bh_fused.barneshut_fused_robust`` with both halves fp64,
    the tree through `group_forces` (the K6 df wrapper, or its plain
    version) and the outliers' rectangle through `rect_forces` (K4's
    wrapper by default, or ``rect_accelerations_reference``)."""
    return barneshut_fused_robust(
        pos.to(torch.float64), mass.to(torch.float64), G=G, softening_sq=softening_sq,
        outlier_slots=outlier_slots, return_stats=return_stats, group_forces=group_forces,
        rect_forces=rect_forces, **kw,
    )
