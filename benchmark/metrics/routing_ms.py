"""``routing_ms``: device time of the program's ``vtransform.routing``
spans per query: the gathering of routed rows into per-sample segments
while the V-transform builds its blocks; nothing where the program records
no such span."""

import spans


def read(trace):
    return spans.stage_ms(trace, "vtransform.routing")
