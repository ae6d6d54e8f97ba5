"""``lm_query_mfu_pct``: an LM query's share of the card's peak, the least
time of its parts at the peaks of their precisions by the LM's own count
(``counts_lm.query_parts``: forward, the backward per draw, the token and
routed blocks' expansion, the Gram and the eigensolve) over the untraced
window's ``query_ms``, in percent; nothing outside an LM cell."""

import counts_lm


def read(trace):
    if counts_lm.CONFIG is None:
        return None
    least = counts_lm.least_seconds(counts_lm.query_parts(counts_lm.CONFIG))
    return 100.0 * least / (trace.query_ms / 1e3)
