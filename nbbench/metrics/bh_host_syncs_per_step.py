"""The port's host syncs a KDK step: the count of ``host_sync.*`` spans
(each a point where the host waits for the card or its runtime: the budget's
query, the probe's reads, the persistent chunk guard, the end of a run)
over the count of ``integrate.step`` spans, in the traced jobs."""

from nbbench.metrics._spans import host_syncs


def read(ctx):
    return host_syncs(ctx, "count")
