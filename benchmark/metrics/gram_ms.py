"""``gram_ms``: device time of the program's ``gram`` spans per query: the
mixed Gram (``structured.gram_matrix_mixed``), each span timed on the
stream from its start to its end, idle gaps inside included; nothing where
the program records no spans."""

import spans


def read(trace):
    return spans.stage_ms(trace, "gram")
