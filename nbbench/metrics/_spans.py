"""The port's span table (``nbody_tpu_torch/diag/timing.py``): the count,
host seconds and device seconds of each span name.  The port records spans
only while a profiler records, so after the traced run its table holds the
profiled jobs.  A reader takes ``ctx.spans`` where the context carries a
table (the tests' synthetic ones), else the port's; a port without the
recorder gives None, and so does a span that is not in the table."""


def table(ctx):
    spans = getattr(ctx, "spans", None)
    if spans is not None:
        return spans
    from nbody_tpu_torch.diag import timing

    summary = getattr(timing, "summary", None)
    return None if summary is None else summary()


def per_call_ms(ctx, name: str):
    """Device milliseconds of span `name` over its count."""
    row = (table(ctx) or {}).get(name)
    if not row or not row["count"] or row["device_s"] is None:
        return None
    return 1e3 * row["device_s"] / row["count"]


def host_syncs(ctx, field: str):
    """The sum of `field` ("count" or "host_s") over the ``host_sync.*``
    spans, over the count of ``integrate.step`` (the KDK steps)."""
    spans = table(ctx) or {}
    steps = spans.get("integrate.step", {}).get("count", 0)
    if not steps:
        return None
    return sum(row[field] for name, row in spans.items()
               if name.startswith("host_sync.")) / steps
