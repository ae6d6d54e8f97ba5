"""Operations of a spectrum query on a vision transformer (``networks/vit.py``),
from the configuration's shapes alone: the ViT's own count, which
``counts.query_parts`` (one dense product per sample, no attention) is not.
``vit_query_mfu_pct`` and ``token_gram_roofline`` read it.

The entry of a ViT cell sets :data:`CONFIG` when it prepares the query,
so that the readers, which see only the traced block, know the cell's
shapes; where no ViT cell ran they find ``None`` and report nothing.
``PERF.md`` derives each count.
"""

import counts

CONFIG = None  # the running ViT cell's configuration


def tokens(cfg):
    h, w, _ = cfg["image"]
    return (h // cfg["patch"]) * (w // cfg["patch"]) + 1


def token_linears(cfg):
    """``[(in, out)]`` of every Linear that sees the token axis: four a
    block (qkv, attention output, the MLP's two)."""
    d, m = cfg["width"], cfg["mlp"]
    return [(d, 3 * d), (d, d), (d, m), (m, d)] * cfg["depth"]


def patch_macs(cfg):
    """Multiply-adds of one sample's patch embedding."""
    _, _, c = cfg["image"]
    return (tokens(cfg) - 1) * cfg["width"] * c * cfg["patch"] ** 2


def attention_macs(cfg):
    """Multiply-adds of one sample's attention products, ``Q Kᵀ`` and ``A V``:
    ``2 T² width`` a block."""
    return cfg["depth"] * 2 * tokens(cfg) ** 2 * cfg["width"]


def forward_macs(cfg):
    """Multiply-adds of one sample's forward: the patch embedding, every
    token Linear at every position, attention and the head."""
    t = tokens(cfg)
    return (patch_macs(cfg) + t * sum(i * o for i, o in token_linears(cfg))
            + attention_macs(cfg) + cfg["width"] * cfg["num_classes"])


def parameters(cfg):
    """Weights and biases of the network."""
    _, _, c = cfg["image"]
    d, t = cfg["width"], tokens(cfg)
    linears = token_linears(cfg) + [(d, cfg["num_classes"])]
    return (d * c * cfg["patch"] ** 2 + d  # patch embedding
            + d + t * d  # class token, position embedding
            + sum(i * o + o for i, o in linears)
            + 2 * d * (2 * cfg["depth"] + 1))  # LayerNorms


def token_parts(cfg):
    """``{part: (flops, precision)}`` of the token blocks' Gram on ``C' N``
    columns (deflated cross-entropy, ``C' = C − 1``): the expansion
    ``2 C'N T Σ in·out`` in f32 and the Gram of the expanded columns
    ``2 (C'N)² Σ in·out`` on bf16 operands."""
    cols = (cfg["num_classes"] - 1) * cfg["batch"]
    weights = sum(i * o for i, o in token_linears(cfg))
    return {"token_expansion": (2 * cols * tokens(cfg) * weights, "float32"),
            "token_gram": (2 * cols ** 2 * weights, "bfloat16")}


def query_parts(cfg):
    """``{part: (flops, precision)}`` of one deflated spectrum query:

    * ``forward``: ``2 N M``, ``M`` the forward's multiply-adds;
    * ``backward``: one per factor column, the data gradient through every
      layer above the patch embedding, attention's at twice its forward
      (four products for its two), ``2 C'N (M − M_patch + M_attention)``;
    * the token blocks (:func:`token_parts`);
    * ``gram_low``: every other block but the head weight's (patch
      embedding, biases, LayerNorms, embeddings), ``2 (C'N)² D_low`` on
      bf16 operands;
    * ``gram_head``: the head weight's factored block, ``2 N² in + 2 (C'N)²
      out + (C'N)²`` in f32;
    * ``eigensolve``: ``(4/3) (C'N)³``.
    """
    n, c = cfg["batch"], cfg["num_classes"]
    cols = (c - 1) * n
    d = cfg["width"]
    macs = forward_macs(cfg)
    d_low = (parameters(cfg) - sum(i * o for i, o in token_linears(cfg)) - d * c)
    parts = {
        "forward": (2 * n * macs, "float32"),
        "backward": (2 * cols * (macs - patch_macs(cfg) + attention_macs(cfg)), "float32"),
        "gram_low": (2 * cols ** 2 * d_low, "bfloat16"),
        "gram_head": (2 * n ** 2 * d + 2 * cols ** 2 * c + cols ** 2, "float32"),
        "eigensolve": (counts.eigh_flops(cols, 0), "float32"),
    }
    parts.update(token_parts(cfg))
    return parts


def least_seconds(parts):
    return counts.least_seconds(parts)
