"""The token blocks' columns on the tensor cores
(:mod:`vivit_tpu_torch.kernels.token_expand`), on the CPU: the plain
version against a float64 expansion at ragged shapes, its split, and the
route of :meth:`TokenFactor.gram` (the CPU keeps ``torch.bmm`` bit for bit
at every operand dtype; f32 factors off the CPU reach the kernel's wrapper,
at every operand dtype, and never ``TokenFactor.expand``), and the chunks
the benchmark's cells hand the kernel.  The kernel itself runs on the card
only, at ragged shapes and at the cells' chunks: ViT-S/16's, and
Moonlight-16B-A3B's over 2,048 positions (its range loop) and over the
zero-padded per-sample segments of a recorded routing:

    python3 -m pytest tests/test_torch_port_token_expand.py -m card --noconftest -q
"""

import importlib.util
import json
import os

import pytest
import torch

from vivit_tpu_torch import structured
from vivit_tpu_torch.kernels import token_expand as te
from vivit_tpu_torch.precision import gram_blocked, tf32_split
from vivit_tpu_torch.structured import TokenFactor

# ViT-S/16's token Linear layers (in, out) and their chunks at N=128, CF=9
# (``TokenFactor._chunks`` at ``TOKEN_CHUNK_BYTES``): qkv, proj, fc1, fc2
VIT_LAYERS = {"qkv": (384, 1152), "proj": (384, 384), "fc1": (384, 1536), "fc2": (1536, 384)}
VIT_T, VIT_S, VIT_CF = 197, 128, 9
# Moonlight-16B-A3B's token Linear layers (in, out) at the LM cell: 16
# sequences of 2,048 tokens, one Monte-Carlo draw; the dense MLP's gate and
# up projections share a shape
LM_LAYERS = {"q_proj": (2048, 3072), "kv_b_proj": (512, 4096), "o_proj": (2048, 2048),
             "dense_up_proj": (2048, 11264), "dense_down_proj": (11264, 2048),
             "lm_head": (2048, 20480)}
LM_T, LM_S, LM_CF = 2048, 16, 1
# the positions one launch takes at each block width (``z``'s rows in shared
# memory); a longer contraction runs as one launch a range
ROWS = {192: 240, 128: 296}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _factor(t, i, o, cf, s, seed=0, dtype=torch.float32, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn((s, t, i), generator=gen, dtype=torch.float64)
    # cotangents a few decades below the inputs, as scaled ones are
    d = 1e-3 * torch.randn((cf, s, t, o), generator=gen, dtype=torch.float64)
    return TokenFactor(z=z.to(dtype).to(device), delta=d.to(dtype).to(device))


def _exact(leaf, o0, o1, i0, i1):
    """The chunk's columns in float64, and the sums of the terms' magnitudes."""
    d, z = leaf.delta[..., o0:o1].double(), leaf.z[..., i0:i1].double()
    ref = torch.einsum("cnpo,npi->cnoi", d, z).flatten(0, 1)
    mag = torch.einsum("cnpo,npi->cnoi", d.abs(), z.abs()).flatten(0, 1)
    return ref, mag


def _rel(x, ref):
    return float(torch.linalg.vector_norm((x.double() - ref).flatten())
                 / torch.linalg.vector_norm(ref.flatten()))


# (T, in, out, CF, S, chunk): T off every power of two, odd widths, chunks
# that cut both widths raggedly, one CF and several
RAGGED = [(7, 9, 11, 2, 3, (0, 11, 0, 9)),
          (33, 5, 13, 1, 4, (2, 13, 1, 4)),
          (197, 17, 19, 3, 2, (0, 7, 5, 17)),
          (65, 31, 3, 4, 5, (1, 3, 0, 31))]


@pytest.mark.parametrize("t,i,o,cf,s,chunk", RAGGED)
def test_plain_version_is_f32_faithful(t, i, o, cf, s, chunk):
    """Every element within a deterministic f32 bound of the float64 sum
    (the f32 sum's ``T`` roundings and the dropped ``lo·lo``, each below
    ``2^-22`` of its term), and the whole chunk within twice the f32
    ``bmm``'s error."""
    leaf = _factor(t, i, o, cf, s, seed=t + i)
    o0, o1, i0, i1 = chunk
    got = te.token_expand_plain(leaf.z, leaf.delta, o0, o1, i0, i1)
    ref, mag = _exact(leaf, o0, o1, i0, i1)
    assert got.shape == (cf * s, o1 - o0, i1 - i0) and got.dtype == torch.float32
    assert got.is_contiguous()
    bound = (t + 8) * 2.0 ** -23 * mag
    assert bool(((got.double() - ref).abs() <= bound).all())
    bmm = leaf.expand(o0, o1, i0, i1).flatten(0, 1)
    assert _rel(got, ref) <= 2 * max(_rel(bmm, ref), 2.0 ** -24)


@pytest.mark.parametrize("t,i,o,cf,s,chunk", RAGGED)
def test_plain_version_splits_exactly(t, i, o, cf, s, chunk):
    """``hi`` has TF32's 10 mantissa bits, rounds to nearest, and ``hi + lo``
    is the factor bit for bit; the three products of the parts are the
    plain version, term for term in float64."""
    leaf = _factor(t, i, o, cf, s, seed=3 * t)
    o0, o1, i0, i1 = chunk
    for x in (leaf.delta[..., o0:o1], leaf.z[..., i0:i1]):
        hi, lo = tf32_split(x)
        assert torch.equal(hi + lo, x)
        assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
        # to nearest: the rest is at most half a TF32 unit of the value
        assert bool((lo.abs() <= 2.0 ** -11 * x.abs()).all())
    (dh, dl), (zh, zl) = tf32_split(leaf.delta[..., o0:o1]), tf32_split(leaf.z[..., i0:i1])
    parts = sum(torch.einsum("cnpo,npi->cnoi", a.double(), b.double())
                for a, b in ((dl, zh), (dh, zl), (dh, zh))).flatten(0, 1)
    got = te.token_expand_plain(leaf.z, leaf.delta, o0, o1, i0, i1)
    ref, mag = _exact(leaf, o0, o1, i0, i1)
    # the parts miss only lo·lo; the plain version adds f32 roundings of the sums
    assert bool(((parts - ref).abs() <= 2.0 ** -22 * mag).all())
    assert bool(((got.double() - parts).abs() <= (t + 4) * 2.0 ** -24 * mag).all())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    leaf = _factor(5, 4, 6, 2, 3)
    with pytest.raises(TypeError):
        te.token_expand_plain(leaf.z.double(), leaf.delta.double())
    with pytest.raises(ValueError):
        te.token_expand_plain(leaf.z[:2], leaf.delta)
    with pytest.raises(ValueError):
        te.token_expand_plain(leaf.z, leaf.delta, 6, 6)
    with pytest.raises(ValueError):
        te.token_expand_plain(leaf.z[:, :0], leaf.delta[:, :, :0])
    with pytest.raises(ValueError, match="CUDA"):
        te.token_expand_cuda(leaf.z, leaf.delta)


def _chunked_gram(leaf, precision, expand):
    """The Gram of ``TokenFactor.gram``'s loop with ``expand`` forming the
    chunks."""
    out, n = None, leaf.num_cols
    for o0, o1, i0, i1 in leaf._chunks():
        flat = expand(o0, o1, i0, i1).reshape(n, -1)
        if precision is not None:
            flat = flat.to(precision)
        out = gram_blocked(flat, precision, out)
    return out


@pytest.mark.parametrize("chunk_bytes", [4 * 6 * 5, 4 * 6 * 37, 1 << 30])
@pytest.mark.parametrize("precision", [None, torch.bfloat16, torch.float16])
def test_cpu_gram_keeps_bmm_bit_for_bit(monkeypatch, chunk_bytes, precision):
    """On the CPU the chunks are ``TokenFactor.expand``'s, f32 factors or
    float64, at every operand dtype, and nothing is launched."""
    monkeypatch.setattr(structured, "TOKEN_CHUNK_BYTES", chunk_bytes)
    te.LAUNCHES = 0
    for leaf in (_factor(7, 9, 11, 2, 3), _factor(7, 9, 11, 2, 3, dtype=torch.float64)):
        assert leaf._flops()[0] < leaf._flops()[1]
        got = leaf.gram(precision)
        want = _chunked_gram(leaf, precision, lambda *c: leaf.expand(*c))
        assert torch.equal(got, want)
    assert te.LAUNCHES == 0


@pytest.mark.parametrize("precision", [None, torch.bfloat16])
def test_gram_off_the_cpu_reaches_the_kernel(monkeypatch, precision):
    """f32 factors on another device than the CPU go to the kernel's
    wrapper, at every operand dtype, which raises where they are no CUDA
    tensors: there is no fallback to ``TokenFactor.expand``.  ``meta``
    tensors stand for the card's."""
    leaf = _factor(7, 9, 11, 2, 3, device="meta")
    monkeypatch.setattr(TokenFactor, "expand", None)
    with pytest.raises(ValueError, match="CUDA"):
        leaf.gram(precision)

    calls = []

    def kernel(z, delta, o0, o1, i0, i1):
        calls.append((o0, o1, i0, i1))
        return torch.empty((delta.shape[0] * delta.shape[1], o1 - o0, i1 - i0),
                           device=delta.device)

    monkeypatch.setattr(te, "token_expand_cuda", kernel)
    g = leaf.gram(precision)
    assert g.device.type == "meta" and g.shape == (6, 6)
    assert calls == leaf._chunks()


def test_vit_chunks_are_the_kernels_shapes():
    """The chunks ``TokenFactor.gram`` hands the kernel at ViT-S/16, N=128:
    its blocks' widths (192 columns ``i`` for qkv and proj, 128 for fc1 and
    fc2) and 64-row tiles cover each without a ragged edge."""
    shapes = {}
    for name, (i, o) in VIT_LAYERS.items():
        leaf = TokenFactor(z=torch.empty((VIT_S, VIT_T, i), device="meta"),
                           delta=torch.empty((VIT_CF, VIT_S, VIT_T, o), device="meta"))
        shapes[name] = {(o1 - o0, i1 - i0) for o0, o1, i0, i1 in leaf._chunks()}
    assert shapes == {"qkv": {(1152, 192)}, "proj": {(384, 384)}, "fc1": {(1536, 128)},
                      "fc2": {(384, 512)}}
    widths = {name: te._width(ic) for name, ((_, ic),) in shapes.items()}
    assert widths == {"qkv": 192, "proj": 192, "fc1": 128, "fc2": 128}
    for name, ((oc, ic),) in shapes.items():
        assert oc % 64 == 0 and ic % widths[name] == 0


def test_lm_chunks_take_the_range_loop():
    """The chunks ``TokenFactor.gram`` hands the kernel at the LM cell: 16
    columns, so whole layers or halves and thirds of the widest (the dense
    MLP's, the head's), each over 2,048 positions, more than one launch
    takes at its block width."""
    shapes = {}
    for name, (i, o) in LM_LAYERS.items():
        leaf = TokenFactor(z=torch.empty((LM_S, LM_T, i), device="meta"),
                           delta=torch.empty((LM_CF, LM_S, LM_T, o), device="meta"))
        assert leaf._flops()[0] < leaf._flops()[1]
        shapes[name] = {(o1 - o0, i1 - i0) for o0, o1, i0, i1 in leaf._chunks()}
        for _, ic in shapes[name]:
            assert -(-LM_T // ROWS[te._width(ic)]) >= 7
    assert shapes == {"q_proj": {(3072, 2048)}, "kv_b_proj": {(4096, 512)},
                      "o_proj": {(2048, 2048)}, "dense_up_proj": {(11264, 1024)},
                      "dense_down_proj": {(2048, 5632)},
                      "lm_head": {(20480, 683), (20480, 682)}}


@pytest.mark.parametrize("ic,width", [(1, 128), (64, 128), (65, 128), (100, 128), (130, 192),
                                      (192, 192), (200, 128), (256, 128), (320, 192)])
def test_block_width_pads_the_fewest_columns(ic, width):
    assert te._width(ic) == width


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs on the card only")
    return torch.device("cuda", 0)


def _against_bmm(leaf, chunk, card):
    """The kernel's chunk against the f32 ``bmm``'s, its plain version's and
    float64: ``(kernel error, bmm error, kernel vs plain, bf16 share that
    differs, whether the roundings are neighbours (:func:`bf16_neighbours`),
    launches)``."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        bmm = leaf.expand(*chunk).flatten(0, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    before = te.LAUNCHES
    got = te.token_expand_cuda(leaf.z, leaf.delta, *chunk)
    torch.cuda.synchronize(card)
    launches = te.LAUNCHES - before
    ref, _ = _exact(leaf, *chunk)
    plain = te.token_expand_plain(leaf.z, leaf.delta, *chunk)
    a, b = got.bfloat16(), bmm.bfloat16()
    differ = float((a != b).float().mean())
    return (_rel(got, ref), _rel(bmm, ref), _rel(got, plain.double()), differ,
            bf16_neighbours(got, bmm, (bmm.double() - ref).abs().max()), launches)


def bf16_neighbours(x, y, f32_err):
    """Whether the bf16 roundings of ``x`` and ``y`` are equal or adjacent
    wherever the f32 values fix them: elements below ``2^8`` times the f32
    path's own largest error ``f32_err`` (cancellations near zero) may round
    further apart, as the f32 path's against float64's do."""
    return bool((te.bf16_apart(x, y) <= 2.0 ** 8 * float(f32_err)).all())


@pytest.mark.card
@pytest.mark.parametrize("layer", sorted(VIT_LAYERS))
def test_kernel_against_plain_and_float64(card, layer):
    """At ViT-S/16's first chunk of each layer: the kernel within twice the
    f32 ``bmm``'s error against float64, near its plain version, its bf16
    roundings the f32 path's on at least 99.9% of elements and neighbours
    elsewhere (:func:`bf16_neighbours`), one launch."""
    i, o = VIT_LAYERS[layer]
    leaf = _factor(VIT_T, i, o, VIT_CF, VIT_S, seed=i + o, device=card)
    err, err_bmm, vs_plain, share, one_ulp, launches = _against_bmm(
        leaf, leaf._chunks()[0], card)
    assert launches == 1
    assert err <= 2 * err_bmm and vs_plain <= 4 * err_bmm
    assert share <= 1e-3 and one_ulp


# (T, in, out, CF, S, chunk, launches): odd widths and strides (4-byte
# copies), T past one launch's rows at each width (192: 240 rows; 128:
# 296), a chunk off the block's width
CARD_RAGGED = [(7, 9, 11, 2, 3, (0, 11, 0, 9), 1),
               (197, 17, 19, 3, 2, (0, 7, 5, 17), 1),
               (300, 192, 64, 2, 5, (0, 64, 0, 192), 2),
               (600, 64, 20, 1, 3, (4, 20, 0, 64), 3),
               (400, 260, 130, 2, 4, (2, 130, 4, 260), 2)]


@pytest.mark.card
@pytest.mark.parametrize("t,i,o,cf,s,chunk,launches", CARD_RAGGED)
def test_kernel_at_ragged_shapes(card, t, i, o, cf, s, chunk, launches):
    leaf = _factor(t, i, o, cf, s, seed=t, device=card)
    err, err_bmm, vs_plain, _, _, ran = _against_bmm(leaf, chunk, card)
    assert ran == launches
    assert err <= 2 * err_bmm and vs_plain <= 4 * err_bmm


def _card_factor(t, i, o, cf, s, seed, card):
    """Random f32 factors drawn on the card (the LM's are too large to draw
    in float64 on the host)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    return TokenFactor(z=torch.randn((s, t, i), generator=gen, device=card),
                       delta=1e-3 * torch.randn((cf, s, t, o), generator=gen, device=card))


@pytest.mark.card
@pytest.mark.parametrize("layer", sorted(LM_LAYERS))
def test_kernel_at_lm_chunks(card, layer):
    """At the LM cell's first chunk of each layer, 2,048 positions: the
    bars of :func:`test_kernel_against_plain_and_float64`, one launch a
    range of positions."""
    i, o = LM_LAYERS[layer]
    leaf = _card_factor(LM_T, i, o, LM_CF, LM_S, i + o, card)
    chunk = leaf._chunks()[0]
    err, err_bmm, vs_plain, share, one_ulp, launches = _against_bmm(leaf, chunk, card)
    assert launches == -(-LM_T // ROWS[te._width(chunk[3] - chunk[2])])
    assert err <= 2 * err_bmm and vs_plain <= 4 * err_bmm
    assert share <= 1e-3 and one_ulp


@pytest.fixture(scope="module")
def recorded_samples():
    """:func:`_recorded_samples` on the first CUDA card; skips the tests
    where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs on the card only")
    return _recorded_samples(torch.device("cuda", 0))


def _recorded_samples(card):
    """The samples of the rows that the first MoE layer of the LM cell's
    network (``benchmark/networks/moonlight.py`` at its configuration, cut
    to its first two layers, weights from seed 0) routes to expert 0 on
    16 × 2,048 normals."""
    path = os.path.join(REPO, "benchmark", "networks", "moonlight.py")
    spec = importlib.util.spec_from_file_location("bench_networks_moonlight_card", path)
    moon = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(moon)
    with open(os.path.join(REPO, "benchmark", "configs", "moonlight_16b_a3b_l5_e8.json")) as f:
        cfg = {**json.load(f), "num_hidden_layers": 2}
    gen = torch.Generator(device=card).manual_seed(0)
    net = moon.build(cfg, card, gen)
    X = torch.randn((LM_S, LM_T), generator=gen, device=card)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            net(X)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    tokens = (net.routing["recorded"][0] == 0).any(dim=-1).nonzero().squeeze(-1)
    return tokens // LM_T


@pytest.mark.card
@pytest.mark.parametrize("i,o", [(2048, 1408), (1408, 2048)])
def test_kernel_at_routed_segments(card, recorded_samples, i, o):
    """An expert's block (its gate/up and down projections) over the
    per-sample segments of a recorded routing, padded with zero rows to the
    longest: the bars of :func:`test_kernel_against_plain_and_float64`, and
    the block within twice the ``bmm``'s error of the ragged segments'
    float64 block."""
    sample = recorded_samples
    counts = torch.bincount(sample, minlength=LM_S)
    assert int(counts.min()) < int(counts.max())
    gen = torch.Generator(device=card).manual_seed(i)
    z = torch.randn((sample.numel(), i), generator=gen, device=card)
    delta = 1e-3 * torch.randn((LM_CF, sample.numel(), o), generator=gen, device=card)
    leaf = structured.routed_factor(z, delta, sample, LM_S)
    assert leaf.z.shape == (LM_S, int(counts.max()), i)
    chunk = leaf._chunks()[0]
    assert chunk == (0, o, 0, i)
    err, err_bmm, vs_plain, share, one_ulp, launches = _against_bmm(leaf, chunk, card)
    assert launches == -(-leaf.z.shape[1] // ROWS[te._width(i)])
    assert err <= 2 * err_bmm and vs_plain <= 4 * err_bmm
    assert share <= 1e-3 and one_ulp
    got = te.token_expand_cuda(leaf.z, leaf.delta, *chunk).double().view(LM_CF, LM_S, o, i)
    ragged = torch.stack([torch.einsum("cro,ri->coi", delta[:, sample == n].double(),
                                       z[sample == n].double()) for n in range(LM_S)], 1)
    assert _rel(got, ragged) <= 2 * err_bmm
