"""``token_gram_roofline``: the token blocks' Gram against its least time,
in percent: the expansion at the card's f32 peak plus the products at its
bf16 peak (``counts_vit.token_parts`` of the running ViT cell's shapes)
over ``token_gram_ms``; nothing outside a ViT cell or where the program
records no ``gram.token_blocks`` span."""

import counts_vit
import spans


def read(trace):
    ms = spans.stage_ms(trace, "gram.token_blocks")
    if ms is None or counts_vit.CONFIG is None:
        return None
    least = counts_vit.least_seconds(counts_vit.token_parts(counts_vit.CONFIG))
    return 100.0 * least / (ms / 1e3)
