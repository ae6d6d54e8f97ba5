"""``vtransform_ms``: device time of the program's ``vtransform`` spans per
query: the V-transform (``structured.structured_ggn_sqrt_vt``: the tapped
forward, the loss factors, the backwards, the blocks), each span timed on
the stream from its start to its end, idle gaps inside included; nothing
where the program records no spans."""

import spans


def read(trace):
    return spans.stage_ms(trace, "vtransform")
