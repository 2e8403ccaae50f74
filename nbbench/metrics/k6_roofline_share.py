"""K6 (``csrc/bh_fused.cu``, ``bh_fused_*_kernel``: the pricing pass and the
full kernel): the interactions the group MAC needs on each traced job's
input (``work/k6.py``, computed) times the job's evaluations, 19 flops
each, at the peak of the cell's precision, over K6's device time in the
traced window.  Evaluations: the port's K6 evaluation counter."""

from nbbench.metrics._roofline import share
from nbbench.work import k6


def read(ctx):
    evals = ctx.counters.get("k6_evaluations", 0)
    if not evals or not ctx.jobs:
        return None
    per_job = evals / len(ctx.jobs)
    count = {}
    for p in set(ctx.jobs):
        pos, _, mass = ctx.inputs[p]
        count[p] = k6.interactions(ctx.config, pos, mass)
    work = per_job * sum(count[p] for p in ctx.jobs) * k6.FLOPS_PER_INTERACTION
    return share(ctx, r"\bbh_fused_\w*kernel\b", work, ctx.cell["dtype"])
