"""``token_gram_ms``: device time of the program's ``gram.token_blocks``
spans per query: the Gram of the factored token blocks (the Linear layers
that see the token axis), their chunked expansion and products, one span a
Gram, timed on the stream from its start to its end, idle gaps inside
included; nothing where the program records no such span."""

import spans


def read(trace):
    return spans.stage_ms(trace, "gram.token_blocks")
