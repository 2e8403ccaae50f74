"""Milliseconds of device time, per Barnes-Hut force evaluation, of every
kernel in the traced window that is not K6: the Morton sort, the grid, the
groups and the scatter of the one-shot path, or the persistent layout's
table rebuild, resorts and kick/drift, and the integrator's updates."""

import re


def read(ctx):
    evals = ctx.counters.get("k6_evaluations", 0)
    if not evals:
        return None
    rx = re.compile(r"\bbh_fused_\w*kernel\b")
    other = sum(dur for name, _, dur in ctx.timeline.kernels if not rx.search(name))
    return 1e3 * other / evals
