"""``routed_gram_ms``: device time of the program's ``gram.routed_blocks``
spans per query: the Gram of the blocks whose rows were gathered from the
flattened batch (a mixture of experts' dispatch), one span a Gram, timed on
the stream from its start to its end; nothing where the program records no
such span."""

import spans


def read(trace):
    return spans.stage_ms(trace, "gram.routed_blocks")
