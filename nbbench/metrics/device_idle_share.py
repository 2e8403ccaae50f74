"""The share of the traced window in which no kernel, copy or set ran on
the device: 100 (1 - busy / window), busy the union of their intervals."""


def read(ctx):
    if ctx.timeline.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.timeline.busy_s / ctx.timeline.window_s)
