"""Operations of a GGN-MC spectrum query on a language model
(``networks/moonlight.py``), from the configuration's shapes alone:
``lm_query_mfu_pct`` reads it.

The entry of an LM cell sets :data:`CONFIG` (the configuration with the
cell's ``mc_samples``) when it prepares the query, so
that the reader, which sees only the traced block, knows the cell's shapes;
where no LM cell ran it finds ``None`` and reports nothing.  The rows an
expert held here receives are counted at their expectation under even
routing, ``S·T·k / router_experts`` (the routing of a batch is a draw).
``PERF.md`` derives each count.
"""

import counts

CONFIG = None  # the running LM cell's configuration


def sequence(cfg):
    """The tokens of a sequence (the harness's input ``[S, T]``)."""
    return cfg["image"][0]


def token_linears(cfg):
    """``[(in, out)]`` of every Linear that sees every token: per layer the
    attention's four, the dense MLP's three or the router and the shared
    experts' three; the output head."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    r = cfg["kv_lora_rank"]
    out = []
    for i in range(cfg["num_hidden_layers"]):
        out += [(d, h * (nope + rope)), (d, r + rope), (r, h * (nope + v)), (h * v, d)]
        if i < cfg["first_k_dense_replace"]:
            w = cfg["intermediate_size"]
        else:
            out.append((d, cfg["router_experts"]))
            w = cfg["moe_intermediate_size"] * cfg["n_shared_experts"]
        out += [(d, w), (d, w), (w, d)]
    return out + [(d, cfg["vocab_size"])]


def moe_layers(cfg):
    return cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]


def expert_weights(cfg):
    """``Σ in·out`` of one routed expert (SwiGLU)."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def expert_rows(cfg):
    """Rows one held expert receives from the batch, at their expectation."""
    return cfg["batch"] * sequence(cfg) * cfg["num_experts_per_tok"] / cfg["router_experts"]


def attention_macs(cfg):
    """Multiply-adds of one sequence's causal attention products in one
    layer, ``Q Kᵀ`` and ``A V`` over the ``T(T+1)/2`` pairs kept."""
    t = sequence(cfg)
    return (cfg["num_attention_heads"] * t * (t + 1) // 2
            * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"]))


def parameters(cfg):
    """Parameters held: the Linears, the held experts, the embedding and
    the RMSNorms."""
    d = cfg["hidden_size"]
    return (sum(i * o for i, o in token_linears(cfg))
            + moe_layers(cfg) * cfg["n_routed_experts"] * expert_weights(cfg)
            + cfg["vocab_size"] * d
            + cfg["num_hidden_layers"] * (2 * d + cfg["kv_lora_rank"]) + d)


def query_parts(cfg):
    """``{part: (flops, precision)}`` of one query on ``S`` sequences of
    ``T`` tokens with ``M`` draws (``N = S·M`` columns):

    * ``forward``: ``2 (S·T Σ in·out + routed + S·L·attention)``, the held
      experts' ``routed = moe_layers · n_routed_experts · rows · Σ_expert``;
    * ``backward``: one per draw, the data gradient through every Linear
      and attention's at twice its forward;
    * ``expansion``: every token and routed block's columns, ``2 N T Σ
      in·out`` and ``2 N (rows/S) Σ_expert`` each, as three TF32 passes;
    * ``gram``: ``2 N² D`` on bf16 operands, ``D`` the parameters held;
    * ``eigensolve``: ``(4/3) N³``.
    """
    s, t, m = cfg["batch"], sequence(cfg), cfg["mc_samples"]
    n = s * m
    lin = sum(i * o for i, o in token_linears(cfg))
    routed_w = moe_layers(cfg) * cfg["n_routed_experts"] * expert_weights(cfg)
    routed = expert_rows(cfg) * routed_w
    attn = s * cfg["num_hidden_layers"] * attention_macs(cfg)
    return {
        "forward": (2 * (s * t * lin + routed + attn), "float32"),
        "backward": (2 * m * (s * t * lin + routed + 2 * attn), "float32"),
        "expansion": (3 * 2 * n * (t * lin + expert_rows(cfg) / s * routed_w), "tf32"),
        "gram": (2 * n ** 2 * parameters(cfg), "bfloat16"),
        "eigensolve": (counts.eigh_flops(n, 0), "float32"),
    }


def least_seconds(parts):
    return counts.least_seconds(parts)
