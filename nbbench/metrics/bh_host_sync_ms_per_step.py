"""Host milliseconds a KDK step spent inside the port's host syncs (the
``host_sync.*`` spans, host clock) over the count of ``integrate.step``
spans, in the traced jobs."""

from nbbench.metrics._spans import host_syncs


def read(ctx):
    r = host_syncs(ctx, "host_s")
    return None if r is None else 1e3 * r
