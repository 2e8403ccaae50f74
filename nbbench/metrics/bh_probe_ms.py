"""Device milliseconds of the start-up capacity probe, one a job: the span
``bh.probe`` (``bh_fused.check_fused``: one one-shot force evaluation and its
two host reads of the stats)."""

from nbbench.metrics._spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "bh.probe")
