"""Moonlight-16B-A3B (a DeepSeek-V3 model) as a plain ``nn.Module``, built
from a configuration.

The equations of DeepSeek-V3 (arXiv:2412.19437, §2.1), with multi-head
latent attention from DeepSeek-V2 (arXiv:2405.04434, §2.1), following the
public Hugging Face modelling code of ``deepseek_v3`` (``DeepseekV3...``):

* token embedding, then ``num_hidden_layers`` pre-norm layers, each ``x +
  attention(RMSNorm(x))`` then ``x + mlp(RMSNorm(x))``, a final RMSNorm and
  an untied output head over the vocabulary;
* attention with no query compression (``q_lora_rank`` null): ``q_proj``
  gives each head ``qk_nope_head_dim + qk_rope_head_dim`` values;
  ``kv_a_proj_with_mqa`` gives a latent of ``kv_lora_rank`` and one shared
  rotary key of ``qk_rope_head_dim``; the latent goes through an RMSNorm
  and ``kv_b_proj`` to each head's ``qk_nope_head_dim`` key and
  ``v_head_dim`` value; rotary embedding (θ ``rope_theta``, no scaling, the
  HF code's de-interleave before ``rotate_half``) on the rotary parts;
  causal softmax attention of scale ``1/√(qk_nope + qk_rope)``; ``o_proj``;
* the first ``first_k_dense_replace`` layers take a SwiGLU MLP of width
  ``intermediate_size``; the others a mixture of experts: a router of
  ``router_experts`` outputs, sigmoid scores, the top ``num_experts_per_tok``
  by score plus a correction bias (``noaux_tc`` with one group, so the
  group step keeps every expert), their scores normalized to sum 1
  (``norm_topk_prob``) and scaled by ``routed_scaling_factor``; SwiGLU
  experts of width ``moe_intermediate_size``; plus ``n_shared_experts``
  shared experts as one SwiGLU of ``n_shared_experts`` times that width;
* RMSNorm of ``rms_norm_eps``, SiLU, no attention bias.

This card holds ``n_routed_experts`` of the router's ``router_experts``
experts (ids ``first_expert .. first_expert + n_routed_experts − 1``,
``first_expert`` 0 unless the configuration names it), one card's share
under expert parallelism: the router keeps its width and picks over all of them, the
card computes what its own experts give for the tokens routed to them, and
what the absent experts would add is left out.  The vocabulary is the
first ``vocab_size`` ids, for the embedding and the head alike.

Departures from the HF code, each with the same arithmetic where it says
so:

* the router is an ``nn.Linear(hidden, router_experts, bias=False)`` (HF: a
  bare ``Parameter`` under ``F.linear``; the same product); the correction
  bias is a zero buffer;
* attention is ``F.scaled_dot_product_attention(..., is_causal=True)``: the
  ``[S, heads, T, T]`` probabilities are never stored (eager ones would
  take 4.3 GB a layer at 16 sequences of 2,048 tokens); query and key are
  built with ``torch.cat`` in place of writes into an empty tensor;
* the expert dispatch is ``moe_infer``'s sort, gather and slice over this
  card's experts only: the rows of the pairs routed to them are gathered
  (HF gathers every pair's, for the exchange of expert parallelism);
  every held expert runs, on zero rows too (HF skips an expert with no
  rows), and each expert's output rows are weighted and
  added into the layer's output rows (``index_add``) in place of HF's
  ``[S·T·top_k, hidden]`` scatter buffer followed by a weighted sum: the
  same terms, another order of summation;
* the input is ``X [S, T]`` of standard normals, mapped to token ids as
  ``floor(Φ(x) · vocab_size)`` in float32, clamped to the vocabulary, so
  every dtype of the network reads the same ids from the same ``X``;
* weights are drawn from a seed (the checkpoint is not used).

**The routing decision is an input.**  ``net.routing`` is a dict: with
``"replay"`` None a forward records each MoE layer's choice ``[S·T, top_k]``
in ``"recorded"``; with ``"replay"`` a list of such choices it takes them in
place of its own, and counts in ``"invalid"`` the tokens whose replayed
choice is not a top-``top_k`` of its own scores (an unchosen score above a
chosen one by more than ``1e-5`` of the chosen).  A float64 forward thus
follows a float32 forward's discrete decisions and checks them.

Configuration keys: those of the HF config used here, plus
``router_experts``, ``first_expert`` (optional) and ``init`` (``std`` of
the truncated normal).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

# a replayed choice is invalid where an unchosen score exceeds a chosen one
# by more than this share of the chosen
ROUTING_SLACK = 1e-5


def token_ids(X, vocab):
    """``floor(Φ(x) · vocab)`` in float32, clamped: uniform ids from normals."""
    ids = torch.floor(torch.special.ndtr(X.float()) * vocab).long()
    return ids.clamp_(0, vocab - 1)


def layers(cfg):
    """Every Linear as ``{"kind": "dense", "name", "in", "out"}``, in the
    layout of ``cnn3c3d.layers``, for the harness's ``counts.query_parts``:
    that count takes each layer once a sample, not once a token, and leaves
    attention, routing and the embedding out, so it is not the LM's;
    ``counts_lm`` gives the LM's own."""
    out = []
    for i, (name, fan_in, fan_out) in enumerate(_linears(cfg)):
        out.append({"kind": "dense", "name": f"{i}.{name}", "in": fan_in, "out": fan_out})
    return out


def _linears(cfg):
    """``[(name, in, out)]`` of every Linear, the experts held included."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    r = cfg["kv_lora_rank"]
    out = []
    for i in range(cfg["num_hidden_layers"]):
        out += [("q_proj", d, h * (nope + rope)), ("kv_a_proj_with_mqa", d, r + rope),
                ("kv_b_proj", r, h * (nope + v)), ("o_proj", h * v, d)]
        if i < cfg["first_k_dense_replace"]:
            widths = [cfg["intermediate_size"]]
        else:
            out.append(("gate", d, cfg["router_experts"]))
            widths = ([cfg["moe_intermediate_size"]] * cfg["n_routed_experts"]
                      + [cfg["moe_intermediate_size"] * cfg["n_shared_experts"]])
        for w in widths:
            out += [("gate_proj", d, w), ("up_proj", d, w), ("down_proj", w, d)]
    out.append(("lm_head", d, cfg["vocab_size"]))
    return out


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def _rope(x, cos, sin):
    """HF's ``apply_rotary_pos_emb``: the pairs de-interleaved, then rotated."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return x * cos + _rotate_half(x) * sin


class MLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, hidden, width):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, width, bias=False)
        self.up_proj = nn.Linear(hidden, width, bias=False)
        self.down_proj = nn.Linear(width, hidden, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Attention(nn.Module):
    """Multi-head latent attention with no query compression."""

    def __init__(self, cfg):
        super().__init__()
        d, self.heads = cfg["hidden_size"], cfg["num_attention_heads"]
        self.nope, self.rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        self.v_dim, self.rank = cfg["v_head_dim"], cfg["kv_lora_rank"]
        self.theta = cfg["rope_theta"]
        self.q_proj = nn.Linear(d, self.heads * (self.nope + self.rope), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, self.rank + self.rope, bias=False)
        self.kv_a_layernorm = nn.RMSNorm(self.rank, eps=cfg["rms_norm_eps"])
        self.kv_b_proj = nn.Linear(self.rank, self.heads * (self.nope + self.v_dim),
                                   bias=False)
        self.o_proj = nn.Linear(self.heads * self.v_dim, d, bias=False)

    def _cos_sin(self, t, like):
        inv = 1.0 / (self.theta ** (torch.arange(0, self.rope, 2, device=like.device,
                                                 dtype=like.dtype) / self.rope))
        freqs = torch.outer(torch.arange(t, device=like.device, dtype=like.dtype), inv)
        emb = torch.cat((freqs, freqs), dim=-1)
        return emb.cos(), emb.sin()

    def forward(self, x):
        s, t, _ = x.shape
        h = self.heads
        q = self.q_proj(x).view(s, t, h, self.nope + self.rope).transpose(1, 2)
        q_nope, q_pe = torch.split(q, [self.nope, self.rope], dim=-1)
        kv_a = self.kv_a_proj_with_mqa(x)
        latent, k_pe = torch.split(kv_a, [self.rank, self.rope], dim=-1)
        k_pe = k_pe.view(s, t, 1, self.rope).transpose(1, 2)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent))
        kv = kv.view(s, t, h, self.nope + self.v_dim).transpose(1, 2)
        k_nope, v = torch.split(kv, [self.nope, self.v_dim], dim=-1)
        cos, sin = self._cos_sin(t, x)
        q_pe, k_pe = _rope(q_pe, cos, sin), _rope(k_pe, cos, sin)
        q = torch.cat((q_nope, q_pe), dim=-1)
        k = torch.cat((k_nope, k_pe.expand(s, h, t, self.rope)), dim=-1)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             scale=(self.nope + self.rope) ** -0.5)
        return self.o_proj(out.transpose(1, 2).reshape(s, t, h * self.v_dim))


class MoE(nn.Module):
    """The router over all ``router_experts``, the held experts' part of the
    result, and the shared experts."""

    def __init__(self, cfg, routing, index):
        super().__init__()
        d, w = cfg["hidden_size"], cfg["moe_intermediate_size"]
        self.top_k, self.scale = cfg["num_experts_per_tok"], cfg["routed_scaling_factor"]
        self.norm_topk = cfg["norm_topk_prob"]
        self.routing, self.index = routing, index
        self.first, self.router_experts = cfg.get("first_expert", 0), cfg["router_experts"]
        self.gate = nn.Linear(d, cfg["router_experts"], bias=False)
        self.register_buffer("e_score_correction_bias", torch.zeros(cfg["router_experts"]))
        self.experts = nn.ModuleList(MLP(d, w) for _ in range(cfg["n_routed_experts"]))
        self.shared_experts = MLP(d, w * cfg["n_shared_experts"])

    def _route(self, x):
        """``(topk_idx, topk_weight)`` of each token, ``[S·T, top_k]``."""
        scores = self.gate(x).sigmoid()
        choice = scores + self.e_score_correction_bias.to(scores.dtype)
        replay = self.routing["replay"]
        if replay is None:
            idx = torch.topk(choice, self.top_k, dim=-1, sorted=False)[1]
        else:
            idx = replay[self.index].to(x.device)
            chosen = choice.gather(1, idx)
            others = choice.scatter(1, idx, float("-inf")).max(dim=-1).values
            least = chosen.min(dim=-1).values
            bad = others - least > ROUTING_SLACK * least.abs()
            self.routing["invalid"] += int(bad.sum())
        self.routing["recorded"].append(idx)
        weight = scores.gather(1, idx)
        if self.top_k > 1 and self.norm_topk:
            weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, weight * self.scale

    def forward(self, x):
        s, t, d = x.shape
        flat = x.view(-1, d)
        idx, weight = self._route(flat)
        # moe_infer: token–expert pairs sorted by expert, the rows gathered
        pairs = idx.view(-1)
        order = pairs.argsort()
        counts = torch.bincount(pairs, minlength=self.router_experts).tolist()
        first = sum(counts[:self.first])
        held = order[first:first + sum(counts[self.first:self.first + len(self.experts)])]
        rows = flat[held // self.top_k]
        y = torch.zeros_like(flat)
        start = 0
        for e, expert in enumerate(self.experts):
            end = start + counts[self.first + e]
            out = expert(rows[start:end])
            pick = held[start:end]
            y = y.index_add(0, pick // self.top_k,
                            out * weight.view(-1)[pick].unsqueeze(-1).to(out.dtype))
            start = end
        return y.view(s, t, d) + self.shared_experts(x)


class Layer(nn.Module):
    def __init__(self, cfg, routing, index):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
        self.input_layernorm = nn.RMSNorm(d, eps=eps)
        self.self_attn = Attention(cfg)
        self.post_attention_layernorm = nn.RMSNorm(d, eps=eps)
        if index < cfg["first_k_dense_replace"]:
            self.mlp = MLP(d, cfg["intermediate_size"])
        else:
            self.mlp = MoE(cfg, routing, index - cfg["first_k_dense_replace"])

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class Net(nn.Module):
    """The network of the module docstring: ``X [S, T]`` → logits
    ``[S, T, vocab_size]``."""

    def __init__(self, cfg):
        super().__init__()
        d, self.vocab = cfg["hidden_size"], cfg["vocab_size"]
        self.routing = {"replay": None, "recorded": [], "invalid": 0}
        self.embed_tokens = nn.Embedding(self.vocab, d)
        self.layers = nn.ModuleList(Layer(cfg, self.routing, i)
                                    for i in range(cfg["num_hidden_layers"]))
        self.norm = nn.RMSNorm(d, eps=cfg["rms_norm_eps"])
        self.lm_head = nn.Linear(d, self.vocab, bias=False)

    def forward(self, X):
        self.routing["recorded"] = []
        x = self.embed_tokens(token_ids(X, self.vocab))
        for layer in self.layers:
            x = layer(x)
        return self.lm_head(self.norm(x))


def build(cfg, device, generator):
    """The network on ``device``, its weights drawn from ``generator``
    parameter by parameter: a normal truncated at two standard deviations,
    of std ``cfg["init"]["std"]`` (HF's ``initializer_range``), for every
    Linear weight and the embedding; RMSNorm weights one."""
    with torch.device("meta"):
        net = Net(cfg)
    net = net.to_empty(device=device).eval()
    std = cfg["init"]["std"]
    # inverse CDF of the normal truncated to [-2, 2]
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.RMSNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, (nn.Linear, nn.Embedding)):
                u = torch.rand(m.weight.numel(), generator=generator, device=device,
                               dtype=torch.float64)
                x = math.sqrt(2) * torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1) * std
                m.weight.copy_(x.view(m.weight.shape))
        for b in net.buffers():
            b.zero_()
    return net
