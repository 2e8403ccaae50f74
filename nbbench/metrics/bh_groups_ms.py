"""Device milliseconds of the one-shot path's Morton groups an
evaluation: the span ``bh.groups`` (``bh_fused.prepare_fused``, around
``group_inputs``: the group ranges, the budget's query of the free memory
(a host sync), the packing and K6's source rows)."""

from nbbench.metrics._spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "bh.groups")
