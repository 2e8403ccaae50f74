"""The comparison that decides `correct`.

A job's answer is its final positions and velocities.  Each checked job is
compared with the plain reference (``reference.py``) run on the same input,
by two numbers, each the root-mean-square gap over every body as a share of
the root-mean-square change the reference makes over the job:

* ``pos_gap`` = |x - x_ref| / |x_ref - x_0|
* ``vel_gap`` = |v - v_ref| / |v_ref - v_0|

with |.| the 2-norm over all coordinates of all bodies.  A job that
returned its input unchanged reads 1 on both.  A norm, not a widest gap:
Barnes-Hut's answer jumps where rounding moves a cell across the MAC's
boundary, which a few groups of a million bodies see in any two sound
computations, and a widest gap reads those jumps; a precision lost
everywhere, or one body's answer moved by its own displacement, moves the
norm.  The limits are
the cell's (``cells/<name>.json`` ``limits``), set between the program's
readings and the control's (PERF.md says from which).
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("pos_gap", "vel_gap")


def gaps(out, ref, start) -> dict:
    """The two numbers of one job: `out`, `ref` and `start` are (pos, vel)
    pairs of (n, 3) arrays: the program's answer, the reference's and the
    input."""
    res = {}
    for name, a, r, s in zip(NUMBERS, out, ref, start):
        a, r, s = (np.asarray(x, dtype=np.float64) for x in (a, r, s))
        moved = float(np.linalg.norm(r - s))
        gap = float(np.linalg.norm(a - r)) if a.shape == r.shape else math.inf
        res[name] = gap / moved if moved > 0 else math.inf
    return res


def worst(readings: list[dict]) -> dict:
    """The largest of each number over the checked jobs (inf with none)."""
    return {k: max((r[k] for r in readings), default=math.inf) for k in NUMBERS}


def judge(readings: list[dict], limits: dict, failed: int) -> tuple[bool, dict]:
    """(correct, the numbers beside their limits): correct when at least
    one job was checked, no job failed and every number is finite and
    within its limit."""
    w = worst(readings)
    shown = {k: {"value": w[k], "limit": limits[k]} for k in NUMBERS}
    ok = (bool(readings) and failed == 0
          and all(math.isfinite(w[k]) and w[k] <= limits[k] for k in NUMBERS))
    return ok, shown
