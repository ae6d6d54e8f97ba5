"""A DeepSeek-V3-style mixture-of-experts language model on the port's
tapped path, on the CPU: the benchmark's Moonlight network
(``benchmark/networks/moonlight.py``, loaded by path) at a tiny size
(hidden 32, 2 heads, rotary and plain query/key widths 4 and 8, values 8, a
latent of 16, one dense and one MoE layer, 8 routed experts top-2 of which
4 are held, one shared expert, a vocabulary of 50; 3 sequences of 12
tokens, 2 Monte-Carlo draws).

The spectrum is held to ``engine="vjp"`` and to the float64 reference
(``benchmark/reference/ggn_lm.py``); the RMSNorm, embedding and routed
expert blocks to per-sample VJPs, with routings handed in that leave a
sample without rows for an expert and give an expert exactly as many rows
as there are samples; the sequence cross-entropy's factors to the exact
block-diagonal Hessian; two 4-expert shares to the uncut layer; the
``[S, C]`` factors to their formulas before sequences, bit for bit; and a
2-D Linear input whose rows cannot be placed to the generic engine.
"""

import importlib.util
import itertools
import os
import sys

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import vivit_tpu_torch as vtt
from vivit_tpu_torch import structured, tapped
from vivit_tpu_torch.engines import forward_fn, module_params
from vivit_tpu_torch.ggn import ggn_sqrt_vt, v_factors
from vivit_tpu_torch.structured import gram_matrix_mixed, structured_ggn_sqrt_vt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"hidden_size": 32, "num_attention_heads": 2, "qk_nope_head_dim": 8,
       "qk_rope_head_dim": 4, "v_head_dim": 8, "kv_lora_rank": 16, "num_hidden_layers": 2,
       "first_k_dense_replace": 1, "intermediate_size": 48, "moe_intermediate_size": 16,
       "n_routed_experts": 4, "router_experts": 8, "num_experts_per_tok": 2,
       "n_shared_experts": 1, "routed_scaling_factor": 2.446, "norm_topk_prob": True,
       "rms_norm_eps": 1e-5, "rope_theta": 50000.0, "vocab_size": 50, "init": {"std": 0.3}}
S, T, M, KEY = 3, 12, 2, 20250218
HELD = CFG["n_routed_experts"]


def _load(name, path, package=None):
    spec = importlib.util.spec_from_file_location(
        name, path, submodule_search_locations=package)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def moon():
    return _load("bench_networks_moonlight",
                 os.path.join(REPO, "benchmark", "networks", "moonlight.py"))


@pytest.fixture(scope="module")
def ggn_lm():
    folder = os.path.join(REPO, "benchmark", "reference")
    _load("bench_reference", os.path.join(folder, "__init__.py"), [folder])
    import importlib

    return importlib.import_module("bench_reference.ggn_lm")


def _net(moon, dtype=torch.float64, seed=1, **cfg):
    net = moon.build({**CFG, **cfg}, torch.device("cpu"), torch.Generator().manual_seed(seed))
    return net.to(dtype)


def _batch(seed=2):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((S, T), generator=gen), torch.zeros(S, dtype=torch.long)


class _Recording(vtt.CrossEntropyLoss):
    """Mean cross-entropy that keeps its last Monte-Carlo labels."""

    def mc_draws(self, *args, **kwargs):
        self.labels = super().mc_draws(*args, **kwargs)
        return self.labels


def _reference_columns(ggn_lm, net, X, loss, routing):
    """``{name: [M·S, numel]}``: per-sample VJPs, exact (float64 columns),
    under the program's labels and routing."""
    u = ggn_lm.uniforms(KEY, S, M, T)
    v, bad_labels, _ = ggn_lm.columns(net, X, loss.labels, routing, u, low=torch.float64,
                                      dtype=torch.float64, tf32=False)
    assert bad_labels == 0
    out, offset = {}, 0
    for name, p in net.named_parameters():
        out[name] = v[:, offset:offset + p.numel()]
        offset += p.numel()
    return out


def _dense_moe_forward(self, x):
    """The MoE layer with every held expert on every token, weighted by its
    routing weight (zero where not chosen): the same function, without the
    data-dependent dispatch that ``torch.func.vmap`` cannot follow."""
    s, t, d = x.shape
    flat = x.view(-1, d)
    idx, weight = self._route(flat)
    w = torch.zeros((flat.shape[0], self.router_experts), dtype=weight.dtype,
                    device=x.device).scatter(1, idx, weight)
    y = sum(expert(flat) * w[:, self.first + e, None] for e, expert in enumerate(self.experts))
    return y.view(s, t, d) + self.shared_experts(x)


def _spectrum(vt, precision=None):
    return torch.linalg.eigvalsh(gram_matrix_mixed(vt, generic_precision=precision).double())


def test_tapped_spectrum_matches_vjp_engine(moon, monkeypatch):
    """In float64, the tapped engine's Gram (routed blocks, token blocks of
    the attention and the flattened router, RMSNorm and embedding taps)
    against the generic engine's per-sample vjps on the same function."""
    net = _net(moon)
    X, y = _batch()
    loss = vtt.CrossEntropyLoss("mean")
    tapped.GENERIC_PARAMS = 0
    got = _spectrum(structured_ggn_sqrt_vt(net, loss, X, y, mc_samples=M, key=KEY))
    assert tapped.GENERIC_PARAMS == 0
    monkeypatch.setattr(type(net.layers[1].mlp), "forward", _dense_moe_forward)
    want = _spectrum(structured_ggn_sqrt_vt(net, loss, X, y, mc_samples=M, key=KEY,
                                            engine="vjp"))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10 * want.max())


# Tolerances relative to the largest eigenvalue: the port runs the network in
# float32 (TF32 off) against the float64 reference under the same decisions;
# f32 Gram 4.6e-7 seen (5e-5 leaves 100x room); bf16 operands on both sides,
# rounded from float32 and float64 values, 3.1e-6 seen (3e-5 leaves 10x;
# the reference's bf16 Gram lies 1.2e-4 from its f32 one, so the bound also
# holds the rounding to the operands)
@pytest.mark.parametrize("gram_precision,tol", [(None, 5e-5), ("bf16", 3e-5)])
def test_spectrum_matches_float64_reference(moon, ggn_lm, gram_precision, tol):
    net = _net(moon, torch.float32)
    X, y = _batch()
    loss = _Recording("mean")
    (got,) = vtt.eigvalsh_structured(net, loss, X, y, mc_samples=M, key=KEY,
                                     gram_precision=gram_precision, eig_backend="dc",
                                     device="cpu")
    routing = list(net.routing["recorded"])
    u = ggn_lm.uniforms(KEY, S, M, T)
    with torch.no_grad():
        assert torch.equal(ggn_lm.labels(net(X), u), loss.labels)
    low = torch.bfloat16 if gram_precision else torch.float32
    want, bad_labels, bad_routing = ggn_lm.spectrum(net, X, loss.labels, routing, u, low=low)
    assert bad_labels == bad_routing == 0
    assert got.shape == (S * M,)
    assert (got.double() - want).abs().max() <= tol * want.max()


def test_norm_and_embedding_blocks_equal_per_sample_vjps(moon, ggn_lm):
    net = _net(moon)
    X, y = _batch()
    loss = _Recording("mean")
    vt = structured_ggn_sqrt_vt(net, loss, X, y, mc_samples=M, key=KEY)
    want = _reference_columns(ggn_lm, net, X, loss, list(net.routing["recorded"]))
    norms = [n for n, m in net.named_modules() if isinstance(m, nn.RMSNorm)]
    assert len(norms) == 3 * CFG["num_hidden_layers"] + 1
    for name in norms:
        leaf = vt[f"{name}.weight"]
        assert type(leaf) is torch.Tensor
        torch.testing.assert_close(leaf.reshape(M * S, -1), want[f"{name}.weight"],
                                   rtol=0, atol=1e-13)
    emb = vt["embed_tokens.weight"]
    assert type(emb) is structured.EmbeddingFactor
    flat = emb.expand().reshape(M * S, -1)
    torch.testing.assert_close(flat, want["embed_tokens.weight"], rtol=0, atol=1e-13)
    # its Gram in table chunks, and its products, against the materialized block
    torch.testing.assert_close(emb.gram(), flat @ flat.T, rtol=0, atol=1e-12)
    gv = torch.randn((2, M * S), dtype=torch.float64)
    torch.testing.assert_close(emb.v_mat_prod(gv).reshape(2, -1), gv @ flat, rtol=0,
                               atol=1e-12)
    mat = torch.randn((2, CFG["vocab_size"], CFG["hidden_size"]), dtype=torch.float64)
    torch.testing.assert_close(emb.vt_mat_prod(mat), flat @ mat.reshape(2, -1).T, rtol=0,
                               atol=1e-12)


def _routing_case(net, X, case):
    """A routing ``[S·T, 2]`` per MoE layer to hand the network: its own
    choice, or its own choice changed so that sample 1 routes no row to
    expert 0, or so that expert 1 gets exactly ``S`` rows (from samples 0,
    0 and 2; a block of as many rows as samples, by chance)."""
    with torch.no_grad():
        net.routing["replay"] = None
        net(X)
    (idx,) = [r.clone() for r in net.routing["recorded"]]
    def drop(rows, expert):
        for r in rows:
            row = idx[r]
            if (row == expert).any():
                other = [e for e in range(CFG["router_experts"])
                         if e not in row.tolist() and e != expert][-1]
                row[row == expert] = other

    if case == "empty_segment":
        drop(range(T, 2 * T), 0)
        assert not (idx[T:2 * T] == 0).any()
    elif case == "rows_as_samples":
        drop(range(S * T), 1)
        for r in (0, 1, 2 * T + 5):
            idx[r, 1] = 1
        assert int((idx == 1).sum()) == S
    return [idx]


@pytest.mark.parametrize("case", ["own", "empty_segment", "rows_as_samples"])
def test_routed_blocks_equal_per_sample_vjps(moon, ggn_lm, case):
    """Each held expert's three weights as :class:`RoutedFactor` blocks,
    materialized, against the per-sample VJPs, and their Gram; the rows
    placed are those routed to the held experts."""
    net = _net(moon)
    X, y = _batch()
    routing = _routing_case(net, X, case)
    net.routing["replay"] = routing
    loss = _Recording("mean")
    tapped.GENERIC_PARAMS = tapped.ROUTED_ROWS = structured.ROUTED_BLOCKS = 0
    vt = structured_ggn_sqrt_vt(net, loss, X, y, mc_samples=M, key=KEY)
    assert tapped.GENERIC_PARAMS == 0
    assert tapped.ROUTED_ROWS == int((routing[0] < HELD).sum())
    assert structured.ROUTED_BLOCKS == 3 * HELD
    want = _reference_columns(ggn_lm, net, X, loss, routing)
    net.routing["replay"] = None
    for e in range(HELD):
        for lin in ("gate_proj", "up_proj", "down_proj"):
            name = f"layers.1.mlp.experts.{e}.{lin}.weight"
            leaf = vt[name]
            assert type(leaf) is structured.RoutedFactor, name
            flat = leaf.expand().reshape(M * S, -1)
            torch.testing.assert_close(flat, want[name], rtol=0, atol=1e-13, msg=name)
            torch.testing.assert_close(leaf.gram(), want[name] @ want[name].T, rtol=0,
                                       atol=1e-12, msg=name)
    if case == "empty_segment":
        leaf = vt["layers.1.mlp.experts.0.gate_proj.weight"]
        assert leaf.z[1].abs().max() == 0 and leaf.delta[:, 1].abs().max() == 0
    if case == "rows_as_samples":
        assert vt["layers.1.mlp.experts.1.up_proj.weight"].z.shape[:2] == (S, 2)
    flat = torch.cat([want[name] for name in want], dim=1)
    torch.testing.assert_close(gram_matrix_mixed(vt), flat @ flat.T, rtol=0, atol=1e-11)


def test_sequence_factors_give_the_block_diagonal_hessian():
    """Over logits ``[S, T, V]`` (V = 5), the exact factors' outer product is
    each sample's Hessian of its loss (block-diagonal over the positions),
    and so is the Monte-Carlo factors' expectation, summed over every label
    of every position weighted by its probability."""
    from torch.func import hessian

    s, t, v = 2, 3, 5
    f = torch.randn((s, t, v), generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    y = torch.zeros((s, t), dtype=torch.long)
    for reduction in ("mean", "sum"):
        loss = vtt.CrossEntropyLoss(reduction)
        want = torch.stack([hessian(lambda fn: loss.per_sample(fn[None], y[n:n + 1])[0])(f[n])
                            .reshape(t * v, t * v) for n in range(s)])
        exact = loss.sqrt_hessian(f, y).reshape(s, t * v, t * v)
        torch.testing.assert_close(exact.mT @ exact, want, rtol=0, atol=1e-14)
        p = torch.softmax(f, dim=-1)
        mc = torch.zeros_like(want)
        for labels in itertools.product(range(v), repeat=t):
            draws = torch.tensor(labels).expand(s, 1, t)
            weight = p[:, torch.arange(t), torch.tensor(labels)].prod(dim=1)  # [S]
            sm = loss.sqrt_hessian_mc(f, y, draws).reshape(s, 1, t * v)
            mc += weight[:, None, None] * (sm.mT @ sm)
        torch.testing.assert_close(mc, want, rtol=0, atol=1e-14)
    draws = vtt.CrossEntropyLoss().mc_draws(f.float(), y, 4, KEY, [0, 1])
    assert draws.shape == (s, 4, t) and draws.dtype == torch.long


def test_class_factors_bit_equal_to_their_formulas():
    """Over ``[S, C]`` logits every loss factor is the formula it was before
    sequences were taken, bit for bit."""
    from vivit_tpu_torch.losses import sample_generator

    f = torch.randn((5, 7), generator=torch.Generator().manual_seed(6))
    y = torch.tensor([0, 3, 6, 2, 2])
    t = torch.randn_like(f)
    loss = vtt.CrossEntropyLoss("mean")
    p = torch.softmax(f, dim=-1)
    eye = torch.eye(7)
    assert torch.equal(loss.sqrt_hessian(f, y), p.sqrt()[..., :, None] * (eye - p[..., None, :]))
    u = torch.stack([torch.rand((3,), generator=sample_generator(KEY, i), dtype=torch.float64)
                     for i in range(5)])
    labels = torch.searchsorted(torch.softmax(f.double(), dim=-1).cumsum(dim=-1), u,
                                right=True).clamp(max=6)
    draws = loss.mc_draws(f, y, 3, KEY, list(range(5)))
    assert torch.equal(draws, labels)
    onehot = F.one_hot(labels, 7).to(f.dtype)
    mc = (p[:, None, :] - onehot) / 3 ** 0.5
    assert torch.equal(loss.sqrt_hessian_mc(f, y, draws), mc)
    hv = p * t - p * (p * t).sum(dim=-1, keepdim=True)
    assert torch.equal(loss.hessian_vp(f, y, t), hv / 5)
    assert torch.equal(vtt.CrossEntropyLoss("sum").hessian_vp(f, y, t), hv)
    assert torch.equal(loss.per_sample(f, y), -F.log_softmax(f, dim=-1).gather(-1, y[:, None])[:, 0])
    scale = (1 / 5 * 5 / 5) ** 0.5
    assert torch.equal(v_factors(loss, f, y, batch_size=5, mc_samples=3, key=KEY), mc * scale)
    exact = p.sqrt()[..., :, None] * (eye - p[..., None, :])
    assert torch.equal(v_factors(loss, f, y, batch_size=5), exact * scale)


def test_expert_shares_add_up_to_the_uncut_layer(moon):
    """The guide's share test: the MoE layer with all 8 experts, and two
    shares of 4 (ids 0-3 and 4-7) with the same weights; the shares'
    outputs, with the shared expert counted once, add up to the uncut
    layer's."""
    full_cfg = {**CFG, "n_routed_experts": 8}
    routing = {"replay": None, "recorded": [], "invalid": 0}
    gen = torch.Generator().manual_seed(9)
    full = moon.MoE(full_cfg, routing, 0).double()
    with torch.no_grad():
        for p in full.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen, dtype=torch.float64))
    shares = []
    for first in (0, 4):
        share = moon.MoE({**CFG, "first_expert": first}, routing, 0).double()
        share.gate.load_state_dict(full.gate.state_dict())
        share.shared_experts.load_state_dict(full.shared_experts.state_dict())
        for e in range(HELD):
            share.experts[e].load_state_dict(full.experts[first + e].state_dict())
        shares.append(share)
    x = torch.randn((S, T, CFG["hidden_size"]), generator=gen, dtype=torch.float64)
    with torch.no_grad():
        want = full(x)
        got = shares[0](x) + shares[1](x) - full.shared_experts(x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-13)


class _Unplaced(nn.Module):
    """A Linear fed the token rows of every sample, flattened position-major
    (``x.transpose(0, 1).reshape(-1, d)``: rows the row rule does not
    place, ``T·S`` of them), or sample-major with their features permuted
    (``flat[:, perm]``, an indexing outside the rule) at one position a
    sample, so that the rows are as many as the samples."""

    def __init__(self, mode, t):
        super().__init__()
        self.mode, self.t = mode, t
        self.inner = nn.Linear(4, 6)
        self.head = nn.Linear(6, 3)
        self.register_buffer("perm", torch.tensor([2, 0, 3, 1]))

    def forward(self, x):
        s, d = x.shape[0], 4
        x = x.reshape(s, self.t, d)
        if self.mode == "position_major":
            h = self.inner(x.transpose(0, 1).reshape(-1, d))
            h = h.reshape(self.t, s, -1).transpose(0, 1)
        else:
            h = self.inner(x.reshape(-1, d)[:, self.perm]).reshape(s, self.t, -1)
        return self.head(torch.tanh(h).mean(dim=1))


@pytest.mark.parametrize("mode,t", [("position_major", 5), ("permuted", 1)])
def test_unplaced_rows_go_to_the_generic_engine(mode, t):
    """The Linear's rows are not placed: its weight and bias go to the
    generic engine, exact, and never become a ``DenseFactor``; with
    ``t = 1`` its leading size is the batch's."""
    torch.manual_seed(5)
    model = _Unplaced(mode, t).double()
    X = torch.randn((S, t * 4), dtype=torch.float64)
    y = torch.tensor([0, 2, 1])
    loss = vtt.CrossEntropyLoss("mean")
    tapped.GENERIC_PARAMS = 0
    vt = structured_ggn_sqrt_vt(model, loss, X, y)
    assert tapped.GENERIC_PARAMS == 4 * 6 + 6
    assert type(vt["inner.weight"]) is torch.Tensor
    assert type(vt["head.weight"]) is structured.DenseFactor
    want = ggn_sqrt_vt(forward_fn(model), loss, module_params(model), X, y)
    torch.testing.assert_close(vt["inner.weight"], want["inner.weight"], rtol=0, atol=1e-13)
    flat = torch.cat([want[k].flatten(2) for k in want], dim=2).flatten(0, 1)
    torch.testing.assert_close(gram_matrix_mixed(vt), flat @ flat.T, rtol=0, atol=1e-12)


def test_blocks_counters_and_spans(moon):
    """The kinds of block, the counters, and the spans of the new blocks:
    ``vtransform.routing`` while the V-transform builds them, one
    ``gram.routed_blocks`` and one ``gram.embedding`` a Gram."""
    from vivit_tpu_torch.utils import trace

    net = _net(moon, torch.float32)
    X, y = _batch()
    loss = vtt.CrossEntropyLoss("mean")
    structured.TOKEN_BLOCKS = structured.ROUTED_BLOCKS = 0
    trace.collect()
    trace.enable(True)
    try:
        vt = structured_ggn_sqrt_vt(net, loss, X, y, mc_samples=M, key=KEY)
        names = [r.name for r in trace.collect()]
        gram_matrix_mixed(vt, generic_precision=torch.bfloat16)
        gram_names = [r.name for r in trace.collect()]
    finally:
        trace.enable(None)
    kinds = {name: type(leaf).__name__ for name, leaf in vt.items()}
    assert kinds["layers.1.mlp.gate.weight"] == "TokenFactor"  # the flattened batch
    assert kinds["layers.0.self_attn.kv_b_proj.weight"] == kinds["lm_head.weight"] == "TokenFactor"
    assert kinds["layers.1.mlp.experts.3.down_proj.weight"] == "RoutedFactor"
    # per layer the attention's 4 and the MLP's 3, the router, the head
    assert structured.TOKEN_BLOCKS == 7 * CFG["num_hidden_layers"] + 1 + 1
    assert structured.ROUTED_BLOCKS == 3 * HELD
    assert names.count("vtransform.routing") == 3 * HELD  # one a routed block
    assert gram_names == ["gram.token_blocks", "gram.routed_blocks", "gram.embedding"]


@pytest.mark.parametrize("precision", [None, torch.bfloat16])
@pytest.mark.parametrize("rows", [6, 65])
def test_blocked_gram_batches_few_columns(monkeypatch, precision, rows):
    """``precision.gram_blocked``, at few rows and more: the whole
    ``_BATCHED_K`` blocks in one batched product, their Grams summed, the
    rest by ``gram``, bit for bit; the Gram of the rounded operands."""
    from vivit_tpu_torch import precision as prec

    monkeypatch.setattr(prec, "_BATCHED_K", 4)
    flat = torch.randn((rows, 61), generator=torch.Generator().manual_seed(8))
    got = prec.gram_blocked(flat, precision)
    low = flat if precision is None else flat.to(precision)
    blocks = low[:, :60].float().unflatten(1, (15, 4)).transpose(0, 1)
    batched = torch.bmm(blocks, blocks.mT).sum(dim=0).add_(prec.gram(flat[:, 60:], precision))
    assert torch.equal(got, batched)
    want = low.double() @ low.double().T
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5 * want.abs().max())
    out = torch.ones((rows, rows))
    assert prec.gram_blocked(flat, precision, out=out) is out
    torch.testing.assert_close(out, got + 1)


class _Gathered(nn.Module):
    """An expert fed rows gathered from the flattened batch, two of sample
    0 and one of sample 2: as many rows as samples, by chance."""

    def __init__(self, t):
        super().__init__()
        self.t = t
        self.expert = nn.Linear(4, 6)
        self.head = nn.Linear(4 + 6, 3)
        self.register_buffer("idx", torch.tensor([0, 1, 2 * t + 1]))

    def forward(self, x):
        s = x.shape[0]
        x = x.reshape(s, self.t, 4)
        h = torch.tanh(self.expert(x.reshape(-1, 4)[self.idx]))
        h = torch.zeros((s * self.t, 6), dtype=h.dtype).index_add(0, self.idx, h)
        return self.head(torch.cat([x.mean(dim=1), h.reshape(s, self.t, 6).mean(dim=1)], 1))


def test_rows_as_many_as_samples_are_placed_by_sample():
    """The expert's input has the batch's leading size, yet its rows are
    two of sample 0 and one of sample 2: its weight and bias are a routed
    block and per-sample sums, each column that of ``autograd`` on the
    batch's forward seeded with one sample's factor row."""
    torch.manual_seed(6)
    t = 4
    model = _Gathered(t).double()
    X = torch.randn((S, t * 4), dtype=torch.float64)
    y = torch.tensor([0, 2, 1])
    loss = vtt.CrossEntropyLoss("mean")
    tapped.GENERIC_PARAMS = tapped.ROUTED_ROWS = 0
    vt = structured_ggn_sqrt_vt(model, loss, X, y)
    assert tapped.GENERIC_PARAMS == 0 and tapped.ROUTED_ROWS == S
    leaf = vt["expert.weight"]
    assert type(leaf) is structured.RoutedFactor and leaf.z.shape[:2] == (S, 2)
    params = dict(model.named_parameters())
    f = model(X)
    factors = v_factors(loss, f.detach(), y, batch_size=S)  # [S, C, C]
    want = {name: torch.zeros((3, S, *p.shape), dtype=torch.float64)
            for name, p in params.items()}
    for n in range(S):
        for c in range(3):
            seed = torch.zeros_like(f)
            seed[n] = factors[n, c]
            grads = torch.autograd.grad(f, list(params.values()), seed, retain_graph=True)
            for name, g in zip(params, grads):
                want[name][c, n] = g
    torch.testing.assert_close(leaf.expand(), want["expert.weight"], rtol=0, atol=1e-13)
    torch.testing.assert_close(vt["expert.bias"], want["expert.bias"], rtol=0, atol=1e-13)
    flat = torch.cat([w.flatten(2) for w in want.values()], dim=2).flatten(0, 1)
    torch.testing.assert_close(gram_matrix_mixed(vt), flat @ flat.T, rtol=0, atol=1e-12)
