"""Device milliseconds of the one-shot path's dense grid an evaluation:
the span ``bh.grid`` (``bh_fused.prepare_fused``, around ``build_grid``:
the terminal segment sums and the coarser levels)."""

from nbbench.metrics._spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "bh.grid")
