"""The three-pass TF32 product's Hopper kernel
(:mod:`vivit_tpu_torch.kernels.three_pass`), on the CPU: its plain version
against float64 at the strip basis's shapes cut to size, the wrapper's
input checks, the layouts it hands the kernel (as they lie, or a
row-major copy), and ``precision.matmul`` reaching the plain version on
the CPU.
The kernel itself runs on the card only:

    python3 -m pytest tests/test_torch_port_three_pass_kernel.py -m card --noconftest -q
"""

import pytest
import torch

from vivit_tpu_torch import precision
from vivit_tpu_torch.eigdc import eigh_dc
from vivit_tpu_torch.kernels import three_pass as tp


def _randn(*shape, seed=0, device="cpu"):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(device)


def _rel(x, ref):
    return float(torch.linalg.vector_norm((x.double() - ref).flatten())
                 / torch.linalg.vector_norm(ref.flatten()))


def _operands(case, device="cpu"):
    """``(a, b)`` of a case: the strip basis's shapes cut to size, ``k`` off
    the promotion's 32 positions and off the kernel's tiles."""
    if case == "a is b":
        X = _randn(288, 288, device=device)
        X = X + X.T
        return X, X
    if case == "a = b^T view":
        Y = _randn(333, 200, device=device)
        return Y.mT, Y
    if case == "[2, k, m]^T view batch":
        Y = _randn(2, 264, 150, device=device)
        return Y.mT, Y
    shapes = {"square": ((256, 256), (256, 256)), "panel": ((256, 256), (256, 136)),
              "[2, k, k] batch": ((2, 200, 200), (2, 200, 200)),
              "ragged k": ((300, 333), (333, 260)),
              "below one tile": ((40, 44), (44, 36))}[case]
    return _randn(*shapes[0], seed=1, device=device), _randn(*shapes[1], seed=2, device=device)


CASES = ["square", "panel", "[2, k, k] batch", "a is b", "a = b^T view",
         "[2, k, m]^T view batch", "ragged k", "below one tile"]


@pytest.mark.parametrize("case", CASES)
def test_plain_version_within_twice_f32(case):
    """The plain version (each operand split once, ``lo·hi + hi·lo + hi·hi``
    of every 32 positions summed in f32) is at most twice the f32 product's
    error against float64, in the product's shape and dtype."""
    a, b = _operands(case)
    got = tp.three_pass_plain(a, b)
    ref = a.double() @ b.double()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) <= 2.0 * _rel(a @ b, ref)


def test_plain_version_sums_each_32_positions():
    """The plain version adds one f32 block of three products for each 32
    positions of ``k`` (the last one short), in order: bit for bit the
    same sum written out."""
    a, b = _operands("ragged k")
    (ah, al), (bh, bl) = precision.tf32_split(a), precision.tf32_split(b)
    want = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 32):
        s = slice(k0, k0 + 32)
        want += al[:, s] @ bh[s] + ah[:, s] @ bl[s] + ah[:, s] @ bh[s]
    assert torch.equal(tp.three_pass_plain(a, b), want)


REFUSED = {
    "float64": (torch.zeros(4, 4, dtype=torch.float64), torch.zeros(4, 4, dtype=torch.float64),
                TypeError, "float32"),
    "bfloat16 b": (torch.zeros(4, 4), torch.zeros(4, 4, dtype=torch.bfloat16), TypeError,
                   "float32"),
    "unequal batches": (torch.zeros(2, 4, 4), torch.zeros(3, 4, 4), ValueError, r"\[b, m, k\]"),
    "k mismatch": (torch.zeros(4, 5), torch.zeros(4, 4), ValueError, r"\[m, k\]"),
    "4-D": (torch.zeros(1, 2, 4, 4), torch.zeros(1, 2, 4, 4), ValueError, r"\[m, k\]"),
    "2-D by 3-D": (torch.zeros(4, 4), torch.zeros(1, 4, 4), ValueError, r"\[m, k\]"),
    "empty": (torch.zeros(0, 4), torch.zeros(4, 4), ValueError, "empty"),
}


@pytest.mark.parametrize("case", REFUSED)
@pytest.mark.parametrize("fn", ["three_pass_plain", "three_pass_cuda"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, fn):
    a, b, error, match = REFUSED[case]
    with pytest.raises(error, match=match):
        getattr(tp, fn)(a, b)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on a CUDA card or raises: no fallback."""
    a, b = _operands("square")
    before = tp.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tp.three_pass_cuda(a, b)
    assert tp.LAUNCHES == before


def test_matmul_reaches_the_plain_version_on_the_cpu(monkeypatch):
    """An engaged ``"high"`` product on the CPU is the plain version, bit
    for bit, called once and counted once; the kernel's counter stays."""
    monkeypatch.setattr(precision, "THREE_PASS_MIN", 64)
    calls = []
    plain = tp.three_pass_plain

    def spy(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return plain(a, b)

    monkeypatch.setattr(tp, "three_pass_plain", spy)
    a, b = _operands("ragged k")
    counts = (precision.THREE_PASS, precision.THREE_PASS_DECLINED, tp.LAUNCHES)
    got = precision.matmul(a, b, "high")
    assert calls == [((300, 333), (333, 260))]
    assert (precision.THREE_PASS, precision.THREE_PASS_DECLINED, tp.LAUNCHES) == (
        counts[0] + 1, counts[1], counts[2])
    assert torch.equal(got, plain(a, b))


def test_kernel_module_counts_its_launches_with_graphs():
    """``LAUNCHES`` is registered with ``graphs.count_launches`` at import,
    so that a replay adds the launches its graphs captured."""
    from vivit_tpu_torch.utils import graphs

    assert tp in graphs._COUNTED


def _pitched(shape, strides, offset=0):
    """A view of ``shape`` and ``strides`` (elements) into fresh storage,
    ``offset`` elements in."""
    size = offset + 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    return _randn(size).as_strided(shape, strides, offset)


# (layout, the 3-D operand, whether TMA reads it as it lies)
LAYOUTS = {
    "row-major": (lambda: _randn(1, 333, 200), True),
    "row-major batch": (lambda: _randn(2, 264, 152), True),
    "row pitch padded": (lambda: _pitched((2, 30, 21), (24 * 31, 24, 1)), True),
    "Y^T view": (lambda: _randn(1, 333, 200).mT, False),
    "odd row pitch": (lambda: _randn(1, 301, 303), False),
    "every other column": (lambda: _randn(1, 40, 64)[:, :, ::2], False),
    "base off 16 bytes": (lambda: _pitched((1, 16, 16), (256, 16, 1), offset=1), False),
    "batch pitch off 16 bytes": (lambda: _pitched((2, 16, 16), (258, 16, 1)), False),
}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_operands_reach_tma_row_major(layout):
    """TMA reads an operand row-major, its row and batch pitches and its base
    on 16 bytes: such an operand reaches the kernel as it lies (a squaring's
    ``X``, a batch); any other (``Yᵀ`` of a ``Yᵀ Y``, an odd pitch, a
    strided view, a base or batch pitch off 16 bytes) as a row-major copy,
    its values kept, its row pitch padded to 4 elements."""
    make, in_place = LAYOUTS[layout]
    x = make()
    got = tp._tma_operand(x)
    assert (got is x) == in_place
    assert torch.equal(got, x)
    assert got.stride(-1) == 1 and got.stride(-2) % 4 == 0 and got.data_ptr() % 16 == 0
    assert x.shape[0] == 1 or got.stride(0) % 4 == 0
    if not in_place:
        assert got.stride(-2) - x.shape[-1] < 4


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs on the card only")
    return torch.device("cuda", 0)


def _against_plain(a, b, card):
    """``(kernel error, f32 error, kernel vs plain, launches)`` against
    float64, TF32 off for the f32 product and the plain version."""
    ref = a.double() @ b.double()
    before = tp.LAUNCHES
    got = tp.three_pass_cuda(a, b)
    torch.cuda.synchronize(card)
    launches = tp.LAUNCHES - before
    with precision.full_f32():
        f32, plain = a @ b, tp.three_pass_plain(a, b)
    return _rel(got, ref), _rel(f32, ref), _rel(got, plain.double()), launches


@pytest.mark.card
def test_kernel_at_the_strip_shapes(card):
    """At ``chip_smoke.THREE_PASS_SHAPES`` (4608³, a 4608³ squaring,
    4608×4608×2400 and its ``Yᵀ Y`` on a transposed view, a 2448³ squaring,
    a ``[2, 1250, 1250]`` batch): one launch each, at most twice the f32
    product's error against float64, near its plain version."""
    from chip_smoke import THREE_PASS_SHAPES, three_pass_operands

    gen = torch.Generator(device=card).manual_seed(0)
    for label, a_shape, b_shape in THREE_PASS_SHAPES:
        a, b = three_pass_operands(a_shape, b_shape, gen)
        err, err_f32, vs_plain, launches = _against_plain(a, b, card)
        assert launches == 1, label
        assert err <= 2 * err_f32 and vs_plain <= 4 * err_f32, (label, err, err_f32, vs_plain)


@pytest.mark.card
@pytest.mark.parametrize("case", CASES + ["odd pitch"])
def test_kernel_at_ragged_shapes(card, case):
    """Short sums off the tiles (the f32 product's own error is smallest
    there): within 4x the f32 product's error, and of its plain version;
    transposed views and an odd pitch through a row-major copy."""
    if case == "odd pitch":
        a, b = _randn(301, 303, device=card), _randn(303, 299, seed=1, device=card)
    else:
        a, b = _operands(case, device=card)
    err, err_f32, vs_plain, launches = _against_plain(a, b, card)
    assert launches == 1
    assert err <= 4 * err_f32 and vs_plain <= 4 * err_f32


@pytest.mark.card
def test_launches_equal_the_engaged_products(card, monkeypatch):
    """The strip route at n=384 (``strip=256``, the threshold lowered to
    128) on the card: one kernel launch for each engaged product."""
    monkeypatch.setattr(precision, "THREE_PASS_MIN", 128)
    lam = torch.exp(-torch.linspace(0, 11, 384, dtype=torch.float64)) * 250.0 + 1e-7
    Q, _ = torch.linalg.qr(_randn(384, 384, seed=1).double())
    H = ((Q * lam) @ Q.T).float().to(card)
    before = (precision.THREE_PASS, tp.LAUNCHES)
    eigh_dc(H, eigenvectors=False, strip=256, guard=None)
    torch.cuda.synchronize(card)
    engaged, launches = precision.THREE_PASS - before[0], tp.LAUNCHES - before[1]
    assert engaged > 0 and launches == engaged


@pytest.mark.card
def test_kernel_replays_in_a_cuda_graph(card):
    """Captured after an eager call and replayed on new operands copied in:
    equal to the eager call on them, bit for bit."""
    a, b = _operands("[2, k, k] batch", device=card)
    tp.three_pass_cuda(a, b)  # builds, raises the shared-memory limit
    torch.cuda.synchronize(card)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tp.three_pass_cuda(a, b)
    a.copy_(_randn(*a.shape, seed=5, device=card))
    b.copy_(_randn(*b.shape, seed=6, device=card))
    graph.replay()
    torch.cuda.synchronize(card)
    assert torch.equal(out, tp.three_pass_cuda(a, b))
