"""A vision transformer on the port's tapped path, on the CPU: the
benchmark's ViT (``benchmark/networks/vit.py``, loaded by path) at a tiny
size (8x8 images, patch 4, width 8, 2 heads, MLP 16, 2 blocks, 3 classes,
N=4).

Its token-shaped Linear weights are :class:`TokenFactor` blocks, its
LayerNorms and its class token and position embedding come from the taps,
and nothing reaches the generic engine.  The spectrum and the top
eigenpairs are held to a float64 GGN built from per-sample Jacobians; the
factored block's Gram and products to the materialized ``Vᵀ`` at several
chunk sizes and both Gram precisions; the tapped blocks to the generic
engine's.
"""

import importlib.util
import os

import pytest
import torch
from torch import nn

import vivit_tpu_torch as vtt
from vivit_tpu_torch import structured, tapped
from vivit_tpu_torch.engines import forward_fn, module_params
from vivit_tpu_torch.ggn import ggn_sqrt_vt
from vivit_tpu_torch.precision import gram
from vivit_tpu_torch.structured import (TokenFactor, gram_matrix_mixed,
                                        structured_ggn_sqrt_vt)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"image": [8, 8, 3], "patch": 4, "width": 8, "heads": 2, "mlp": 16, "depth": 2,
       "num_classes": 3, "init": {"std": 0.5, "ln_eps": 1e-6}}
N = 4
LOSS = vtt.CrossEntropyLoss("mean")


def _vit():
    path = os.path.join(REPO, "benchmark", "networks", "vit.py")
    spec = importlib.util.spec_from_file_location("bench_networks_vit", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def vit():
    return _vit()


def _net(vit, dtype=torch.float32, seed=1):
    """The tiny ViT with its LayerNorm weights and every bias drawn too,
    so that no block is a constant."""
    net = vit.build(CFG, torch.device("cpu"), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.add_(0.3 * torch.randn(m.weight.shape, generator=gen))
            for p in m.parameters(recurse=False):
                if p.dim() == 1 and not (isinstance(m, nn.LayerNorm) and p is m.weight):
                    p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return net.to(dtype)


def _batch(seed=2, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    X = torch.randn((N, *CFG["image"]), generator=gen, dtype=dtype)
    y = torch.randint(0, CFG["num_classes"], (N,), generator=gen)
    return X, y


def _ggn64(net, X, y):
    """The float64 GGN ``(1/N) Σ_n J_nᵀ (diag p − p pᵀ) J_n`` from per-sample
    Jacobians of the logits (``torch.func``), over the flat parameters."""
    from torch.func import functional_call, jacrev, vmap

    net = net.double()
    params = {n: p.detach() for n, p in net.named_parameters()}

    def logits(p, x):
        return functional_call(net, p, (x[None],))[0]

    jac = vmap(jacrev(logits), in_dims=(None, 0))(params, X.double())
    J = torch.cat([jac[n].flatten(2) for n in params], dim=2)  # [N, C, D]
    p = torch.softmax(functional_call(net, params, (X.double(),)), dim=-1)
    H = torch.diag_embed(p) - p[:, :, None] * p[:, None, :]
    return torch.einsum("nci,ncd,ndj->ij", J, H, J) / X.shape[0]


@pytest.fixture(scope="module")
def problem(vit):
    net = _net(vit)
    X, y = _batch()
    G = _ggn64(_net(vit), X, y)
    return net, X, y, G


# Tolerances, relative to the largest eigenvalue.  The port runs the tiny
# ViT in float32 (TF32 off) and its Gram in f32 unless
# ``gram_precision="bf16"``: its eigenvalues sit within a few f32 roundings
# of float64 (1.5e-6 seen; 5e-5 leaves 30x room).  A bf16 Gram rounds the
# operands of every block but the head weight's to 8 bits (2.4e-4 seen;
# 1e-2, near 2^-8 of the largest, leaves 40x room).
EV_F32, EV_BF16 = 5e-5, 1e-2


@pytest.mark.parametrize("backend", ["xla", "dc"])
@pytest.mark.parametrize("gram_precision", [None, "bf16"])
def test_spectrum_matches_float64_ggn(problem, backend, gram_precision):
    net, X, y, G = problem
    (got,) = vtt.eigvalsh_structured(net, LOSS, X, y, deflate_ce_null=True,
                                     eig_backend=backend, gram_precision=gram_precision,
                                     device="cpu")
    k = N * CFG["num_classes"]
    want = torch.linalg.eigvalsh(G)[-k:]
    want = torch.where(want.abs() < 1e-12 * want.abs().max(), 0.0, want)
    tol = EV_F32 if gram_precision is None else EV_BF16
    assert got.shape == (k,)
    assert (got.double() - want).abs().max() <= tol * want.abs().max()
    # the N structural zeros of the deflated CE GGN come back exact
    assert int((got == 0).sum()) == N


def test_tapped_blocks_equal_generic_engine(vit):
    """Every block of the tapped engine, in float64: the LayerNorm, class
    token and position-embedding tensors, the conv and bias blocks, and the
    token blocks and the head's factor materialized, against the generic
    engine's per-sample vjps."""
    net = _net(vit, torch.float64)
    X, y = _batch(dtype=torch.float64)
    tapped.GENERIC_PARAMS = 0
    vt = structured_ggn_sqrt_vt(net, LOSS, X, y, deflate_ce_null=True)
    want = ggn_sqrt_vt(forward_fn(net), LOSS, module_params(net), X, y, deflate_ce_null=True)
    assert tapped.GENERIC_PARAMS == 0
    kinds = {name: type(leaf).__name__ for name, leaf in vt.items()}
    assert kinds["cls_token"] == kinds["pos_embed"] == "Tensor"
    assert kinds["blocks.0.norm1.weight"] == kinds["norm.bias"] == "Tensor"
    assert kinds["blocks.1.qkv.weight"] == kinds["blocks.0.fc2.weight"] == "TokenFactor"
    assert kinds["head.weight"] == "DenseFactor" and kinds["patch.weight"] == "ConvVT"
    for name, leaf in vt.items():
        if isinstance(leaf, TokenFactor):
            leaf = leaf.expand()
        elif isinstance(leaf, structured.DenseFactor):
            leaf = torch.einsum("cno,ni->cnoi", leaf.delta, leaf.z)
        elif isinstance(leaf, tapped.ConvVT):
            leaf = leaf.vt.permute(0, 1, 5, 2, 3, 4)
        assert leaf.shape == want[name].shape, name
        torch.testing.assert_close(leaf, want[name], rtol=0, atol=1e-13, msg=name)


def _token_factor(t, i, o, cf=2, s=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return TokenFactor(z=torch.randn((s, t, i), generator=gen),
                       delta=torch.randn((cf, s, t, o), generator=gen))


def _materialized(leaf):
    return torch.einsum("npi,cnpo->cnoi", leaf.z, leaf.delta)


@pytest.mark.parametrize("chunk_bytes", [1, 4 * 6 * 5, 4 * 6 * 37, 1 << 30])
@pytest.mark.parametrize("precision", [None, torch.bfloat16])
def test_token_block_gram_and_products_equal_materialized(monkeypatch, chunk_bytes,
                                                          precision):
    """Chunks of one ``(o, i)`` pair, of 5, of 37 (ragged) and the whole
    block: the Gram equals the materialized block's under f32 and bf16
    operands, and ``v_mat_prod``/``vt_mat_prod`` equal the materialized
    products."""
    monkeypatch.setattr(structured, "TOKEN_CHUNK_BYTES", chunk_bytes)
    leaf = _token_factor(t=7, i=9, o=11)
    assert leaf._flops()[0] < leaf._flops()[1]  # the expansion is the cheaper form
    flat = _materialized(leaf).reshape(leaf.num_cols, -1)
    want = gram(flat, precision)
    got = leaf.gram(precision)
    # f32: the sums over positions and chunks in another order; bf16: an
    # element whose f32 value moved by an ulp may round to its neighbour
    tol = 1e-5 if precision is None else 1e-3
    torch.testing.assert_close(got, want, rtol=0, atol=tol * want.abs().max())
    vecs = torch.randn((4, leaf.num_cols), generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(leaf.v_mat_prod(vecs), (vecs @ flat).reshape(4, 11, 9),
                               rtol=1e-5, atol=1e-5)
    mat = torch.randn((4, 11, 9), generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(leaf.vt_mat_prod(mat), flat @ mat.reshape(4, -1).T,
                               rtol=1e-5, atol=1e-5)


def test_token_block_chunks_cover_the_block_within_the_bound(monkeypatch):
    monkeypatch.setattr(structured, "TOKEN_CHUNK_BYTES", 4 * 6 * 37)
    leaf = _token_factor(t=7, i=9, o=11)
    chunks = leaf._chunks()
    cells = {(o, i) for o0, o1, i0, i1 in chunks for o in range(o0, o1) for i in range(i0, i1)}
    assert cells == {(o, i) for o in range(11) for i in range(9)}
    assert sum((o1 - o0) * (i1 - i0) for o0, o1, i0, i1 in chunks) == 11 * 9
    assert all(4 * leaf.num_cols * (o1 - o0) * (i1 - i0) <= 4 * 6 * 37
               for o0, o1, i0, i1 in chunks)


def test_token_block_takes_the_tt_form_where_cheaper():
    """Few positions and wide layers: the ``T×T`` form costs less and gives
    the materialized Gram in f32 (under either operand precision)."""
    leaf = _token_factor(t=2, i=64, o=64)
    assert leaf._flops()[1] < leaf._flops()[0]
    want = gram(_materialized(leaf).reshape(leaf.num_cols, -1))
    for precision in (None, torch.bfloat16):
        torch.testing.assert_close(leaf.gram(precision), want, rtol=0,
                                   atol=1e-5 * want.abs().max())


def test_token_gram_is_one_span_a_gram(vit, problem):
    from vivit_tpu_torch.utils import trace

    net, X, y, _ = problem
    vt = structured_ggn_sqrt_vt(net, LOSS, X, y, deflate_ce_null=True)
    trace.collect()
    trace.enable(True)
    try:
        gram_matrix_mixed(vt)
    finally:
        trace.enable(None)
    names = [r.name for r in trace.collect()]
    assert names == ["gram.token_blocks"]


class _Misused(nn.Module):
    """A ``[1, D]`` parameter used in a product over its last axis, which a
    per-sample copy would change: it must reach the generic engine."""

    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(5, 4)
        self.gain = nn.Parameter(torch.randn(1, 4))
        self.norm = nn.BatchNorm1d(4).eval()

    def forward(self, x):
        h = self.norm(self.dense(x.flatten(1)))
        return torch.stack([h @ self.gain.T, h.sum(1, keepdim=True)], dim=1)[..., 0] + h[:, :2]


def test_generic_params_counts_what_leaves_the_table(vit, problem):
    net, X, y, _ = problem
    tapped.GENERIC_PARAMS = 0
    structured.TOKEN_BLOCKS = 0
    vtt.eigvalsh_structured(net, LOSS, X, y, deflate_ce_null=True, device="cpu")
    assert tapped.GENERIC_PARAMS == 0
    assert structured.TOKEN_BLOCKS == 4 * CFG["depth"]

    torch.manual_seed(3)
    model = _Misused().double()
    Xm = torch.randn(3, 5, dtype=torch.float64)
    ym = torch.tensor([0, 1, 0])
    vt = structured_ggn_sqrt_vt(model, LOSS, Xm, ym)
    # the BatchNorm's weight and bias and the misused gain
    assert tapped.GENERIC_PARAMS == 4 + 4 + 4
    want = ggn_sqrt_vt(forward_fn(model), LOSS, module_params(model), Xm, ym)
    torch.testing.assert_close(vt["gain"], want["gain"], rtol=0, atol=1e-13)
    flat = torch.cat([want[k].flatten(2) for k in want], dim=2).flatten(0, 1)
    torch.testing.assert_close(gram_matrix_mixed(vt), flat @ flat.T, rtol=0, atol=1e-12)


def test_eigh_topk_matches_reference_eigenpairs(problem):
    net, X, y, G = problem
    k = 3
    evals, evecs = vtt.eigh_topk(net, LOSS, X, y, k, device="cpu")
    w, v = torch.linalg.eigh(G)
    torch.testing.assert_close(evals.double(), w[-k:], rtol=0, atol=EV_F32 * w[-1])
    flat = torch.cat([e.reshape(k, -1) for e in evecs], dim=1).double()  # [k, D]
    assert (w[-k:].diff() > 1e-3 * w[-1]).all()  # separated, so the vectors are defined
    # up to sign, each eigenvector against the reference's
    cos = (flat * v[:, -k:].T).sum(dim=1).abs() / flat.norm(dim=1)
    assert (cos > 1 - 1e-4).all(), cos


def test_route_rule_keeps_a_vit_call_eager(monkeypatch):
    """On an 80 GB card the rule captures 3c3d at N=128 (a 1152-side Gram,
    895,210 parameters: 4.1 GB of f32 Vᵀ) and keeps ViT-S/16 at N=128
    (21,669,514 parameters: 99.8 GB) eager."""
    from types import SimpleNamespace

    from vivit_tpu_torch import engines

    class Card:
        is_cuda = True
        device = "cuda:0"

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(total_memory=80 * 2 ** 30))
    assert engines.captured(Card, 0, "dc", lambda: 1152, lambda: 895_210)
    assert not engines.captured(Card, 0, "dc", lambda: 1152, lambda: 21_669_514)
    assert not engines.captured(Card, 0, "eigh", lambda: 1152, lambda: 21_669_514)
    assert engines.param_count({"a": torch.zeros(3, 4), "b": torch.zeros(5)}) == 17
