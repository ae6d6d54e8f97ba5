"""``vit_query_mfu_pct``: a ViT query's share of the card's peak, the least
time of its parts at the peaks of their precisions by the ViT's own count
(``counts_vit.query_parts``: forward, the backward per factor column,
attention, the token blocks' expansion and every Gram block) over the
untraced window's ``query_ms``, in percent; nothing outside a ViT cell."""

import counts_vit


def read(trace):
    if counts_vit.CONFIG is None:
        return None
    least = counts_vit.least_seconds(counts_vit.query_parts(counts_vit.CONFIG))
    return 100.0 * least / (trace.query_ms / 1e3)
