"""``jacobi_leaf_roofline``: the leaf Jacobi kernel's share of its roofline
over the traced block, in percent (``timeline.roofline_pct``)."""

import counts
import timeline


def read(trace):
    return timeline.roofline_pct(trace, "jacobi_leaf", counts.roofline_seconds)
