"""``query_p99_ms``: the 99th percentile latency of the window's queries
(host clock, issue to synchronised completion): the tail a training loop
feels, which a guard trip's eager rerun sets while trips pass 1%."""

import counts


def read(trace):
    return 1e3 * counts.quantile(trace.latencies, 0.99)
