"""Kernels launched in the traced window over the KDK steps its jobs
completed (the start-up probe and the first force included)."""


def read(ctx):
    if not ctx.steps:
        return None
    return len(ctx.timeline.kernels) / ctx.steps
