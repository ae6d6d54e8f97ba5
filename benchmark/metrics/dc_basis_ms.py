"""``dc_basis_ms``: device time of the program's ``eigh_dc.basis`` spans
per query: ``eigh_dc``'s basis from the root (the strip's KPM, sign
iterations, bulk projection ``P H P`` and trees), timed on the stream from
its start to its end, idle gaps inside included; nothing where the program
records no spans."""

import spans


def read(trace):
    return spans.stage_ms(trace, "eigh_dc.basis")
