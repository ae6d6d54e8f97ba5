"""``dc_polish_ms``: device time of the program's ``eigh_dc.polish`` spans
per query: ``eigh_dc``'s polish (column selection to the second-order
correction: Davies-Modi, windowed Jacobi, edge blocks), timed on the
stream from its start to its end, idle gaps inside included; nothing where
the program records no spans."""

import spans


def read(trace):
    return spans.stage_ms(trace, "eigh_dc.polish")
