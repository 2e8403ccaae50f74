"""Bodies times KDK steps of every job completed in the window, over the
window's seconds (host clock, from the first job's start to the last job's
end)."""


def read(ctx):
    if not ctx.durations:
        return None
    return ctx.n * ctx.steps_per_job * len(ctx.durations) / ctx.window_s
