"""``precision.matmul``'s three-pass TF32 product (``"high"``) on the CPU,
where the kernel's plain version runs the same passes in f32: the split,
the product's error against float64 beside the f32 product's, and where
``eigh_dc`` engages it
(the strip path's basis) or keeps the f32 product (the chain path's
defaults, KPM's thin products).  ``precision.THREE_PASS_MIN`` is lowered so
that products at these sizes reach the three passes.
"""

import math

import pytest
import torch

from vivit_tpu_torch import eigdc, precision
from vivit_tpu_torch.eigdc import eigh_dc
from vivit_tpu_torch.precision import tf32_split

RTOL, ATOL = 1e-4, 5e-6  # the library's eigenvalue bars (BASELINE.md)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def low_threshold(monkeypatch):
    monkeypatch.setattr(precision, "THREE_PASS_MIN", 64)


def _counts():
    return precision.THREE_PASS, precision.THREE_PASS_DECLINED


def _randn(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _spectrum_matrix(lam, seed=0):
    """``Q diag(lam) Qᵀ`` in f32 for a random orthogonal ``Q``."""
    Q, _ = torch.linalg.qr(_randn(len(lam), len(lam), seed=seed).double())
    return ((Q * lam) @ Q.T).float()


def _ties(sign):
    """f32 values whose low 13 mantissa bits are exactly half a TF32 ulp."""
    bits = torch.arange(64, dtype=torch.int32) * (1 << 17) + 0x3F001000
    return sign * bits.view(torch.float32)


SPLIT_CASES = {
    "normal": _randn(300, 200),
    "wide range": _randn(4096) * torch.logspace(-30, 30, 4096),
    "subnormal": _randn(512) * 1e-40,
    "ties +": _ties(1.0),
    "ties -": _ties(-1.0),
    "zeros": torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0 ** -126]),
    "transposed": _randn(6, 10, 8).mT,
    "strided": _randn(6, 10, 8)[:, 2:5, ::2],
}


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_is_exact(case):
    """``hi + lo == x`` bit for bit, ``hi`` a TF32 value (its low 13
    mantissa bits zero) within half a TF32 ulp of ``x`` (2^-11 of a normal
    ``|x|``), ties away from zero, in ``x``'s layout."""
    x = SPLIT_CASES[case]
    hi, lo = tf32_split(x)
    assert torch.equal(hi + lo, x) and hi.shape == lo.shape == x.shape
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert (lo.abs() <= 2.0 ** -137).all() if case == "subnormal" else \
        (lo.abs() <= x.abs() * 2.0 ** -11).all()
    if case.startswith("ties"):
        assert (hi.abs() > x.abs()).all()


def test_split_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32"):
        tf32_split(torch.zeros(4, dtype=torch.float64))


def _operands(case):
    if case == "squaring":
        X = _randn(320, 320)
        X = X + X.T
        return X, X
    if case == "gram":
        Y = _randn(320, 160)
        return Y.mT, Y
    shapes = {"square": ((320, 320), (320, 320)), "panel": ((320, 320), (320, 160)),
              "batched": ((2, 250, 250), (2, 250, 250)),
              "ragged k": ((320, 333), (333, 320)),
              "ragged k batch": ((2, 250, 261), (2, 261, 250))}[case]
    return _randn(*shapes[0], seed=1), _randn(*shapes[1], seed=2)


def _rel_err(x, ref):
    return float(torch.linalg.vector_norm((x.double() - ref).flatten())
                 / torch.linalg.vector_norm(ref.flatten()))


@pytest.mark.parametrize("case", ["square", "panel", "batched", "squaring", "gram",
                                  "ragged k", "ragged k batch"])
def test_three_pass_error_within_twice_f32(case, low_threshold):
    """At the strip basis's shapes cut to size (a square, a panel like
    4608×4608×2400, a ``[2, k, k]`` tree level, ``X @ X`` and ``Yᵀ Y`` with
    one split, and ``k`` off the 32 positions a sum is promoted after): the
    three passes are at most twice the f32 product's error against float64,
    and count once."""
    a, b = _operands(case)
    before = _counts()
    got = precision.matmul(a, b, "high")
    assert _counts() == (before[0] + 1, before[1])
    ref = a.double() @ b.double()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel_err(got, ref) <= 2.0 * _rel_err(a @ b, ref)


@pytest.mark.parametrize("prec", [None, "highest", "high"])
def test_other_products_run_f32(prec):
    """Below the threshold (``"high"``) and at any other name, ``a @ b``
    itself, bit for bit; only ``"high"`` counts, as declined."""
    a, b = _operands("square")
    before = _counts()
    assert torch.equal(precision.matmul(a, b, prec), a @ b)
    assert _counts() == (before[0], before[1] + (prec == "high"))


H384 = _spectrum_matrix(torch.exp(-torch.linspace(0, 11, 384, dtype=torch.float64)) * 250.0
                        + 1e-7, seed=1)


def test_strip_route_engages_and_chain_defaults_do_not(monkeypatch):
    """The strip route at n=384 (``strip=256``, the route of
    ``test_torch_port_eigdc_sweep_configs.py``) runs its large basis
    products as three passes, and its eigenvalues still meet the library's
    bars against float64; the chain path's defaults at n=384 reach no
    ``"high"`` product."""
    monkeypatch.setattr(precision, "THREE_PASS_MIN", 128)
    ref = torch.linalg.eigvalsh(H384.double())
    before = _counts()
    evals = eigh_dc(H384, eigenvectors=False, strip=256, guard=None)[0]
    engaged, declined = (x - y for x, y in zip(_counts(), before))
    assert engaged > 0 and declined > 0
    tol = ATOL * ref.abs().max() + RTOL * ref.abs()
    assert ((evals.double() - ref).abs() <= tol).all()

    before = _counts()
    eigh_dc(H384, eigenvectors=False)
    assert _counts() == before


def test_kpm_thin_products_decline(low_threshold):
    """KPM's products with its 8 probe columns are too thin for three
    passes: each stays f32 and counts as declined."""
    B = _spectrum_matrix(torch.linspace(0, 1, 200, dtype=torch.float64))[None]
    gen = torch.Generator().manual_seed(0)
    before = _counts()
    ref = eigdc._kpm_cdf(B, torch.Generator().manual_seed(0), degree=16)[1]
    cdf = eigdc._kpm_cdf(B, gen, degree=16, prec="high")[1]
    assert _counts() == (before[0], before[1] + 16)
    assert torch.equal(cdf, ref)
    assert math.isclose(float(cdf[0, -1]), 200.0, rel_tol=0.05)
