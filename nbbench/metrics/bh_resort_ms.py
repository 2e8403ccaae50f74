"""Device milliseconds of one resort of the persistent layout: the span
``bh.resort`` (``bh_persistent.resort``: the real slots gathered, sorted and
grouped again, and the int half of the grid rebuilt)."""

from nbbench.metrics._spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "bh.resort")
