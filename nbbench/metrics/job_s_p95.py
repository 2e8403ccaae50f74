"""The 95th percentile of the time to solution over every job of the
window (nearest rank: the smallest duration that at least 95 % of the jobs
do not exceed), host clock, each job fenced once by its copy to the host."""

import math


def read(ctx):
    if not ctx.durations:
        return None
    d = sorted(ctx.durations)
    return d[math.ceil(0.95 * len(d)) - 1]
