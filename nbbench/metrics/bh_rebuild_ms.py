"""Device milliseconds of the persistent layout's table rebuild an
evaluation: the span ``bh.rebuild`` (``bh_persistent._ft_from_state``: the
fixed-point prefix sum over the stale cells and the coarser levels)."""

from nbbench.metrics._spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "bh.rebuild")
