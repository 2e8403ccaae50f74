"""The share of a kernel's roofline: the least time the card could take for
the operations the kernel's evaluations need, over its device time."""

import re

from nbbench import peaks


def kernel_seconds(timeline, pattern: str) -> float:
    rx = re.compile(pattern)
    return sum(dur for name, _, dur in timeline.kernels if rx.search(name))


def share(ctx, pattern: str, flops: float, precision: str):
    """100 x (flops / the card's peak in `precision`) / the device time of
    the kernels whose names match `pattern`; None where no such kernel ran
    or the card is not in the table of peaks."""
    t = kernel_seconds(ctx.timeline, pattern)
    peak = peaks.peak(ctx.kind, precision)
    if t <= 0 or not peak or flops <= 0:
        return None
    return 100.0 * (flops / peak) / t
