"""``query_mfu_pct``: a query's share of the card's peak, the least time of
its parts at the peaks of their precisions (``counts.query_parts``) over the
untraced window's ``query_ms``, in percent."""


def read(trace):
    return 100.0 * trace.least_s / (trace.query_ms / 1e3)
