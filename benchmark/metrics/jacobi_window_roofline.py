"""``jacobi_window_roofline``: the window Jacobi kernel's share of its
roofline over the traced block, in percent (``timeline.roofline_pct``)."""

import counts
import timeline


def read(trace):
    return timeline.roofline_pct(trace, "jacobi_window", counts.roofline_seconds)
