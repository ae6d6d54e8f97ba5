"""``query_median_ms``: the median latency of the window's queries (host
clock, issue to synchronised completion): the replayed path's time, which
a guard trip's rerun does not reach while trips stay under half."""

import counts


def read(trace):
    return 1e3 * counts.quantile(trace.latencies, 0.5)
