"""Device milliseconds of the one-shot path's Morton sort an evaluation:
the span ``bh.sort`` (``bh_fused.prepare_fused``, around ``sort_bodies``:
the keys, the radix sort and the sorted copies), in the probe and every
force evaluation of the traced jobs."""

from nbbench.metrics._spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "bh.sort")
