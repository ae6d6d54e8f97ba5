"""``dc_leaves_ms``: device time of the program's ``leaves`` spans per
query: every small dense solve (``kernels.jacobi.batched_eigh``: the
trees' leaves, the chains' ends, the windows, the edge blocks), under the
basis and the polish alike, timed on the stream from its start to its end,
idle gaps inside included; the span-side counterpart of ``vendor_eigh_ms``;
nothing where the program records no spans."""

import spans


def read(trace):
    return spans.stage_ms(trace, "leaves")
