"""Parity of the port's matrix-free dataset operators and Lanczos spectra
(``vivit_tpu_torch.hessianfree``) with the JAX package's, mirroring
``tests/hessianfree/test_operators.py``.

A tanh MLP over a ``{name: tensor}`` dict and a dataset of equal batches
plus a ragged tail, the same numpy numbers on both sides (flat vectors in
the same leaf order); the JAX side runs on the CPU.  Bars: matvecs rtol
1e-4 / atol 1e-6 (the JAX test's), ``host_stream`` against the on-device
path rtol 1e-5 / atol 1e-7, gradient and loss rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vivit_tpu as vt
from vivit_tpu import hessianfree as jax_hf

import vivit_tpu_torch as vtt
from vivit_tpu_torch import hessianfree as hf
from vivit_tpu_torch.hessianfree.lanczos import _lanczos_from
from vivit_tpu_torch.utils.tree import ravel

N_BATCHES, BATCH, D_IN, H, C = 3, 4, 5, 6, 3
DIM = D_IN * H + H * C
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(reduction="mean", ragged=True):
    """``(jax model_fn, jax params, port model_fn, port params, data, jax
    loss, port loss)``; data is a list of numpy ``(X, y)`` batches."""
    rng = np.random.default_rng(11)
    w = {"w1": (rng.normal(size=(D_IN, H)) / 2).astype(np.float32),
         "w2": (rng.normal(size=(H, C)) / 2).astype(np.float32)}
    data = [(rng.normal(size=(BATCH, D_IN)).astype(np.float32),
             rng.integers(0, C, size=(BATCH,)).astype(np.int32)) for _ in range(N_BATCHES)]
    if ragged:
        data.append((data[0][0][:2], data[0][1][:2]))

    def jax_fn(p, x):
        return jnp.tanh(x @ p["w1"]) @ p["w2"]

    def port_fn(p, x):
        return torch.tanh(x @ p["w1"]) @ p["w2"]

    return (jax_fn, {k: jnp.asarray(v) for k, v in w.items()}, port_fn,
            {k: torch.tensor(v) for k, v in w.items()}, data,
            vt.CrossEntropyLoss(reduction), vtt.CrossEntropyLoss(reduction))


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("kind", ["ggn", "hessian"])
def test_matvec_matches_jax_on_ragged_dataset(kind, reduction):
    jfn, jparams, pfn, pparams, data, jloss, ploss = _setup(reduction)
    jop = getattr(jax_hf, f"{kind}_operator")(jfn, jloss, jparams, data)
    pop = getattr(hf, f"{kind}_operator")(pfn, ploss, pparams, data, device="cpu")
    rng = np.random.default_rng(6)
    for _ in range(2):
        v = rng.normal(size=(DIM,)).astype(np.float32)
        got = pop(torch.tensor(v))
        assert got.shape == (DIM,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(jop(jnp.asarray(v))),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["ggn", "hessian"])
def test_host_stream_matches_on_device(kind):
    _, _, pfn, pparams, data, _, ploss = _setup("mean")
    build = getattr(hf, f"{kind}_operator")
    op_dev = build(pfn, ploss, pparams, data, device="cpu")
    op_host = build(pfn, ploss, pparams, data, host_stream=True, device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(2):
        v = torch.tensor(rng.normal(size=(DIM,)).astype(np.float32))
        np.testing.assert_allclose(op_host(v).numpy(), op_dev(v).numpy(),
                                   rtol=1e-5, atol=1e-7)
    # the SciPy wrapper takes the knob too
    lo = hf.GGNLinearOperator(pfn, ploss, pparams, data, host_stream=True, device="cpu")
    v = rng.normal(size=(DIM,)).astype(np.float32)
    want = hf.GGNLinearOperator(pfn, ploss, pparams, data, device="cpu") @ v
    np.testing.assert_allclose(lo @ v, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_gradient_and_loss_match_jax(reduction):
    jfn, jparams, pfn, pparams, data, jloss, ploss = _setup(reduction)
    g, l = hf.gradient_and_loss(pfn, ploss, pparams, data, device="cpu")
    jg, jl = jax_hf.gradient_and_loss(jfn, jloss, jparams, data)
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    np.testing.assert_allclose(ravel(g).numpy(), np.asarray(vt.utils.tree.ravel(jg)),
                               rtol=1e-5, atol=1e-7)


def test_scipy_wrapper_matches_jax_and_eigsh():
    jfn, jparams, pfn, pparams, data, jloss, ploss = _setup()
    op = hf.GGNLinearOperator(pfn, ploss, pparams, data, check_deterministic=True,
                              device="cpu")
    jop = jax_hf.GGNLinearOperator(jfn, jloss, jparams, data)
    assert op.shape == jop.shape == (DIM, DIM) and op.dtype == np.float32
    v = np.random.default_rng(2).normal(size=(DIM,)).astype(np.float32)
    got = op @ v
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, jop @ v, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(op.matvec(v), got)
    from scipy.sparse.linalg import eigsh

    G = np.stack([op @ e for e in np.eye(DIM, dtype=np.float32)], axis=1)
    top = eigsh(op.as_scipy(), k=1, which="LA", return_eigenvectors=False)
    assert np.isclose(top[0], np.linalg.eigvalsh((G + G.T) / 2)[-1], rtol=1e-3)
    g, l = op.gradient_and_loss()
    assert g.keys() == pparams.keys() and float(l) > 0.0


def test_hessian_operator_class_matches_jax():
    jfn, jparams, pfn, pparams, data, jloss, ploss = _setup()
    op = hf.HessianLinearOperator(pfn, ploss, pparams, data, device="cpu")
    jop = jax_hf.HessianLinearOperator(jfn, jloss, jparams, data)
    v = np.random.default_rng(3).normal(size=(DIM,)).astype(np.float32)
    np.testing.assert_allclose(op @ v, jop @ v, rtol=RTOL, atol=ATOL)


def test_determinism_check_raises():
    """A model that is not deterministic (noise in the forward, as dropout
    would add) fails the constructor's check."""
    _, _, pfn, pparams, data, _, ploss = _setup()
    gen = torch.Generator().manual_seed(0)

    def noisy(p, x):
        return pfn(p, x) + 1e-2 * torch.randn(x.shape[0], C, generator=gen)

    with pytest.raises(RuntimeError, match="deterministic"):
        hf.GGNLinearOperator(noisy, ploss, pparams, data, device="cpu")
    hf.GGNLinearOperator(noisy, ploss, pparams, data, check_deterministic=False,
                         device="cpu")


def test_operator_accepts_one_shot_iterator():
    _, _, pfn, pparams, data, _, ploss = _setup()
    v = torch.tensor(np.random.default_rng(7).normal(size=(DIM,)).astype(np.float32))
    want = hf.ggn_operator(pfn, ploss, pparams, data, device="cpu")(v)
    got = hf.ggn_operator(pfn, ploss, pparams, (b for b in data), device="cpu")(v)
    assert torch.equal(got, want)
    g, l = hf.gradient_and_loss(pfn, ploss, pparams, (b for b in data), device="cpu")
    assert float(l) > 0.0


def test_module_form_and_device_check():
    """An ``nn.Module`` with ``params=None``; parameters elsewhere than the
    device raise."""
    model = torch.nn.Sequential(torch.nn.Linear(D_IN, H), torch.nn.Tanh(),
                                torch.nn.Linear(H, C))
    _, _, _, _, data, _, ploss = _setup()
    op = hf.GGNLinearOperator(model, ploss, None, data, device="cpu")
    dim = sum(p.numel() for p in model.parameters())
    assert op.shape == (dim, dim)
    with pytest.raises(ValueError, match="lies on"):
        hf.ggn_operator(model, ploss, None, data, device="meta")


def test_boundaries_accept_wrapper_directly():
    _, _, pfn, pparams, data, _, ploss = _setup()
    op = hf.GGNLinearOperator(pfn, ploss, pparams, data, check_deterministic=False,
                              device="cpu")
    G = np.stack([op @ e for e in np.eye(DIM, dtype=np.float32)], axis=1)
    true = np.linalg.eigvalsh((G + G.T) / 2)
    lo, hi = hf.approximate_boundaries(op, tol=1e-4)
    assert np.isclose(hi, true[-1], rtol=1e-3, atol=1e-6)


def test_approximate_boundaries_abs_matches_jax():
    A, evals_true = _spd(30, 2)
    got = hf.approximate_boundaries_abs(A, tol=1e-6)
    want = jax_hf.approximate_boundaries_abs(A, tol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, (evals_true[0], evals_true[-1]), rtol=1e-5)


class _Dense:
    """``A @ v`` of a numpy matrix: the same operator for both packages."""

    def __init__(self, A):
        self._A, self.shape = A, A.shape

    def __matmul__(self, v):
        return self._A @ v


def _spd(n, seed, lo=0.5, hi=4.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    evals = np.sort(rng.uniform(lo, hi, size=n))
    return Q @ np.diag(evals) @ Q.T, evals


@pytest.mark.parametrize("tridiagonal", [False, True])
def test_fast_lanczos_matches_jax(tridiagonal):
    A, evals_true = _spd(12, 3, 0.1, 5.0)
    got = hf.fast_lanczos(_Dense(A), ncv=12, seed=0, use_eigh_tridiagonal=tridiagonal)
    want = jax_hf.fast_lanczos(_Dense(A), ncv=12, seed=0, use_eigh_tridiagonal=tridiagonal)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.abs(got[1]), np.abs(want[1]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.sort(got[0]), evals_true, rtol=1e-6, atol=1e-8)


def test_lanczos_from_matches_fast_lanczos_jax():
    """The device sweep from the JAX package's own start vector (its
    ``PRNGKey(0)`` draw, normalized) gives its Ritz values and quadrature
    weights.  12 of 16 steps: nearer the dimension, f32 Lanczos without
    reorthogonalization grows ghost copies whose values amplify the two
    packages' rounding differences (4e-4 at 16 steps)."""
    A, _ = _spd(16, 4)
    A32 = A.astype(np.float32)
    want_ev, want_V = jax_hf.fast_lanczos_jax(lambda v: jnp.asarray(A32) @ v, 16, 12,
                                              jax.random.PRNGKey(0))
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16,), jnp.float32))
    v0 = v0 / np.linalg.norm(v0)
    ev, V = _lanczos_from(lambda v: torch.tensor(A32) @ v, torch.tensor(v0), 12)
    np.testing.assert_allclose(ev.numpy(), np.asarray(want_ev), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.abs(V[0].numpy()), np.abs(np.asarray(want_V)[0]),
                               atol=1e-5)


def test_fast_lanczos_jax_extreme_ritz_values():
    """The port's own draw (a generator seeded with ``key``): the extreme
    Ritz values at the spectrum's edges and every Ritz value inside it."""
    A, evals_true = _spd(16, 4)
    ev, _ = hf.fast_lanczos_jax(lambda v: torch.tensor(A.astype(np.float32)) @ v, 16, 16,
                                key=0, device="cpu")
    ev = np.sort(ev.numpy())
    assert np.isclose(ev[-1], evals_true[-1], rtol=1e-4)
    assert np.isclose(ev[0], evals_true[0], rtol=1e-3)
    assert np.all(ev > evals_true[0] - 1e-3) and np.all(ev < evals_true[-1] + 1e-3)


@pytest.mark.parametrize("log", [False, True], ids=["linear", "log"])
def test_densities_match_jax(log):
    """Both densities, given the same boundaries and seed, equal the JAX
    package's on the same operator."""
    A, evals_true = _spd(40, 9, 0.01, 3.0)
    name = "lanczos_approximate_log_spectrum" if log else "lanczos_approximate_spectrum"
    bounds = (float(evals_true[0]), float(evals_true[-1]))
    kw = dict(ncv=20, num_points=256, num_repeats=2, boundaries=bounds, seed=0)
    grid, density = getattr(hf, name)(_Dense(A), **kw)
    want_grid, want_density = getattr(jax_hf, name)(_Dense(A), **kw)
    np.testing.assert_allclose(grid, want_grid, rtol=1e-12)
    np.testing.assert_allclose(density, want_density, rtol=1e-9, atol=1e-12)
    if not log:
        assert 0.5 < np.trapezoid(density, grid) < 1.5


def test_spectrum_of_ggn_operator_integrates_to_one():
    _, _, pfn, pparams, data, _, ploss = _setup()
    op = hf.GGNLinearOperator(pfn, ploss, pparams, data, check_deterministic=False,
                              device="cpu")
    grid, density = hf.lanczos_approximate_spectrum(op, ncv=20, num_points=256,
                                                    num_repeats=2, seed=0)
    assert 0.5 < np.trapezoid(density, grid) < 1.5


def test_lowrank_and_projector_match_jax():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(20, 3)).astype(np.float32)
    c = rng.uniform(1, 2, size=3).astype(np.float32)
    x = rng.normal(size=20).astype(np.float32)
    op = hf.LowRank(c, A, device="cpu")
    assert op.shape == (20, 20) and op.dtype == np.float32
    np.testing.assert_allclose(op @ x, jax_hf.LowRank(c, A) @ x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(op.as_scipy() @ x, op.matvec(x))
    Q, _ = np.linalg.qr(rng.normal(size=(20, 4)))
    proj = hf.Projector(Q.astype(np.float32), device="cpu")
    y = proj @ x
    np.testing.assert_allclose(y, jax_hf.Projector(Q.astype(np.float32)) @ x,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(proj @ y, y, rtol=1e-4, atol=1e-5)  # idempotent


def test_lowrank_and_projector_take_tensors():
    """Tensors (as ``eigh_topk`` returns them) give the numpy arrays' result."""
    rng = np.random.default_rng(6)
    A = rng.normal(size=(20, 3)).astype(np.float32)
    c = rng.uniform(1, 2, size=3).astype(np.float32)
    x = rng.normal(size=20).astype(np.float32)
    op = hf.LowRank(torch.tensor(c), torch.tensor(A), device="cpu")
    assert op.shape == (20, 20) and op.dtype == np.float32
    np.testing.assert_allclose(op @ torch.tensor(x), hf.LowRank(c, A, device="cpu") @ x,
                               rtol=1e-6, atol=1e-7)
    Q = torch.linalg.qr(torch.tensor(rng.normal(size=(20, 4))))[0]
    proj = hf.Projector(Q, device="cpu")
    assert proj.dtype == np.float64
    np.testing.assert_allclose(proj @ x, hf.Projector(Q.numpy(), device="cpu") @ x,
                               rtol=1e-12, atol=1e-12)


def test_products_run_in_full_f32():
    """The products under the operators turn TF32 off for their matmuls and
    convolutions (on a CUDA card cuDNN would run f32 convolutions in TF32)
    and restore the flags after."""
    from vivit_tpu_torch.ggn import ggn_mat_prod, ggn_vector_product, hessian_vector_product

    _, _, pfn, pparams, data, _, ploss = _setup()
    seen = []

    def recording(p, x):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return pfn(p, x)

    X, y = torch.tensor(data[0][0]), torch.tensor(data[0][1])
    v = {k: torch.ones_like(p) for k, p in pparams.items()}
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        ggn_vector_product(recording, ploss, pparams, X, y, v)
        hessian_vector_product(recording, ploss, pparams, X, y, v)
        ggn_mat_prod(recording, ploss, pparams, X, y, {k: t[None] for k, t in v.items()})
        hf.ggn_operator(recording, ploss, pparams, data, device="cpu")(torch.ones(DIM))
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert seen and all(flags == (False, False) for flags in seen)
    assert after == (True, True)
