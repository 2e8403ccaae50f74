"""Device-memory capacity sizing for the fused Barnes-Hut path —
counterpart of ``nbody_tpu/core/capacity.py``.

The reference sizes its CUDA octree node pool from free VRAM at startup
(cuda/barnes-hut.cu:886-890: ``(free_mem * 3 / 4) / (node_mem + 4)``), so
a run either fits or fails at once with a real number.  The contract kept
here:

1. **Predict**: a closed-form estimate of the path's device residency from
   (n, group_size, keep, ld), checked against the budget before any work,
   so an over-capacity configuration fails with GiB numbers and a knob.
2. **Clamp**: ``auto_keep`` shrinks the group-slot margin toward its
   occupancy floor when the budget is tight.
3. **Measure + prescribe**: ``check_fused`` turns the requirements that
   K6's pricing pass measures (no force evaluation) into the flag value
   that fits.

The budget is BUDGET_FRAC of the free bytes ``torch.cuda.mem_get_info``
reports (``NBODY_HBM_BYTES`` overrides the free bytes); off the card it is
None and every heuristic keeps its legacy value.  The JAX package's table
of TPU memory sizes does not carry over.
"""

from __future__ import annotations

import os

import torch

from nbody_tpu_torch.diag.timing import host_sync
from nbody_tpu_torch.ops.barneshut import CapacityError

# Fraction of the budget the predictive check may plan for — the
# reference's free_mem * 3/4 margin (cuda/barnes-hut.cu:886).
BUDGET_FRAC = 0.75
# Fraction of the budget the slack group slots may take before auto_keep
# shrinks the margin toward its floor.
KEEP_FRAC = 0.25


def free_bytes(device=None) -> int | None:
    """Free device memory now: NBODY_HBM_BYTES if set, else
    ``torch.cuda.mem_get_info`` on a CUDA device, else None."""
    env = os.environ.get("NBODY_HBM_BYTES")
    if env:
        return int(env)
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    with host_sync("capacity.free_bytes"):
        return int(torch.cuda.mem_get_info(device)[0])


def budget_bytes(device=None, frac: float = BUDGET_FRAC) -> int | None:
    """The plannable budget: frac * free device memory (None off the card)."""
    free = free_bytes(device)
    return None if free is None else int(free * frac)


def occupied_groups_floor(n: int, b: int) -> int:
    """Lower margin on the group slot count: ~n/b full chunks plus at most
    one partial chunk per occupied split-level cell (~0.5 n/b), plus slack
    for clustering."""
    return (3 * (n // b)) // 2 + 64


def auto_keep(n: int, b: int, g_max: int, budget: int | None = None) -> int:
    """Group slot capacity: the legacy margin, shrunk toward the occupancy
    floor when the budget is tight (the budget only ever clamps)."""
    base = 3 * (n // b) + 256
    if budget:
        per_slot = 28  # gstart, gcount and five stats lanes, int32
        base = min(base, max(int(budget * KEEP_FRAC) // per_slot,
                             occupied_groups_floor(n, b)))
    return min(g_max, base)


def estimate_fused_bytes(n: int, b: int, keep: int, ld: int) -> dict:
    """Closed-form estimate of the port's fused Barnes-Hut residency (f32),
    by its own buffers: the Morton sort and its sorted copies, the (n, 4)
    [x y z G·m] source array the kernel streams from, the sorted and
    scattered accelerations, the grouping transients, the six (T,) cell
    tables, and the terminal segment sums.  The kernel reads groups in
    place, so unlike the JAX package there are no (G, 4, B) group blocks
    (`b` only enters through `keep`)."""
    cells = (8 ** (ld + 1) - 1) // 7
    terms = {
        "bodies (sort, sorted copies, sources, accelerations, grouping)": 128 * n,
        "group slots (ranges + stats)": 28 * keep,
        "cell tables (com, G·m, count, start)": 24 * cells,
        "terminal segment sums and counts": 40 * 8**ld,
    }
    terms["total"] = sum(terms.values())
    return terms


def ensure_fits(est: dict, what: str, device=None, budget: int | None = None) -> None:
    """Raise CapacityError with GiB numbers and a prescriptive knob when the
    estimate exceeds the device budget.  No-op when the budget is unknown
    (the CPU)."""
    if budget is None:
        budget = budget_bytes(device)
    if budget is None:
        return
    total = est["total"]
    if total <= budget:
        return
    gib = 2**30
    breakdown = ", ".join(f"{k} {v / gib:.2f}" for k, v in est.items() if k != "total")
    raise CapacityError(
        f"{what} needs ~{total / gib:.2f} GiB of device memory but the budget "
        f"is {budget / gib:.2f} GiB ({BUDGET_FRAC:.0%} of free memory; override "
        f"with NBODY_HBM_BYTES).  Breakdown (GiB): {breakdown}.  Lower --bh-ld "
        f"(the cell tables grow 8x per level) or run fewer bodies per card."
    )
