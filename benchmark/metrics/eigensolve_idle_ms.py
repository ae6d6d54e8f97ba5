"""``eigensolve_idle_ms``: the card's idle time in the traced block whose
gap's middle falls inside the host interval of one of the program's
``eigensolve`` spans, per query: the idle that the eigensolve's host side
(launches, copies, waits) leaves the card; nothing where the program
records no spans."""

import spans


def read(trace):
    return spans.idle_ms(trace, "eigensolve")
