"""The port's LOBPCG (``vivit_tpu_torch.lobpcg``) against JAX's
``lobpcg_standard``, which the JAX package's ``topk_eigh(solver="lobpcg")``
calls, and the top-k solvers built on it against float64.

Both sides get the same matrix and the same start block, made with numpy,
and run the same iteration; the JAX side runs on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.sparse.linalg import _extend_basis as jax_extend_basis
from jax.experimental.sparse.linalg import _svqb as jax_svqb
from jax.experimental.sparse.linalg import lobpcg_standard as jax_lobpcg

from tests.test_torch_port_eigh import _ce_gram
from vivit_tpu_torch import deflate
from vivit_tpu_torch.eig import topk_eigh
from vivit_tpu_torch.lobpcg import _extend_basis, _svqb, lobpcg_standard

RTOL, ATOL = 1e-4, 5e-6
VEC_RTOL, VEC_ATOL = 2e-2, 2e-3
EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spectrum_matrix(lam, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((len(lam), len(lam))))
    return ((Q * lam) @ Q.T).astype(np.float32)


MATRICES = {
    "separated": lambda n: _spectrum_matrix(np.exp(-np.linspace(0, 11, n)) * 250.0, n),
    # eight eigenvalues 0.01 apart on top of a spread
    "clustered": lambda n: _spectrum_matrix(
        np.concatenate([10 + 0.01 * np.arange(8), np.linspace(0.1, 5, n - 8)]), n),
    # PSD with exact zeros (a third of the spectrum)
    "zeros": lambda n: _spectrum_matrix(
        np.concatenate([np.zeros(n // 3), np.linspace(0.5, 50, n - n // 3)]), n),
    # the CE-structured Gram of the eigenpair tests: S = n/10 structural zeros
    "ce-gram": lambda n: _ce_gram(n // 10, 10, 3 * n // 4, seed=n)[0],
}
CASES = [("separated", 60, 1), ("separated", 300, 8), ("clustered", 100, 3),
         ("clustered", 300, 8), ("zeros", 60, 1), ("zeros", 200, 5),
         ("ce-gram", 100, 3), ("ce-gram", 300, 8), ("ce-gram", 400, 10)]


def _start(n, k):
    return np.random.default_rng(k).normal(size=(n, k)).astype(np.float32)


def _residual_ratio(A, theta, X):
    """The loop's convergence test on ``(theta, X)``: the largest
    ``‖Ax − θx‖ / (eps·10·n·(‖Ax‖ + θ))`` (below 1 is converged)."""
    A, theta, X = (torch.as_tensor(np.array(a)) for a in (A, theta, X))
    AX = A @ X
    resid = torch.linalg.vector_norm(AX - theta[None] * X, dim=0)
    reltol = (torch.linalg.vector_norm(AX, dim=0) + theta) * A.shape[0] * 10
    return float((resid / (EPS * reltol)).max())


def _assert_vecs_up_to_sign(got, want):
    sign = np.sign(np.sum(got * want, axis=0, keepdims=True))
    np.testing.assert_allclose(got * sign, want, rtol=VEC_RTOL, atol=VEC_ATOL)


@pytest.mark.parametrize("name,n,k", CASES, ids=[f"{c[0]}-{c[1]}-k{c[2]}" for c in CASES])
def test_lobpcg_matches_jax(name, n, k):
    """The same iteration count, θ at rtol 1e-5 and the vectors up to sign.
    A count one apart passes only where, after the smaller count, one of the
    two has its largest residual within 1% of its threshold (the pair that
    converged in one and not in the other)."""
    A, X0 = MATRICES[name](n), _start(n, k)
    theta, U, iters = lobpcg_standard(torch.tensor(A), torch.tensor(X0))
    theta_j, U_j, iters_j = jax_lobpcg(jnp.asarray(A), jnp.asarray(X0), m=100)
    iters_j = int(iters_j)
    assert iters < 100 and abs(iters - iters_j) <= 1, (iters, iters_j)
    if iters != iters_j:
        m = min(iters, iters_j)
        ratios = [_residual_ratio(A, *lobpcg_standard(torch.tensor(A), torch.tensor(X0),
                                                      m=m)[:2]),
                  _residual_ratio(A, *jax_lobpcg(jnp.asarray(A), jnp.asarray(X0), m=m)[:2])]
        assert any(0.99 <= r <= 1.01 for r in ratios), (iters, iters_j, ratios)
    np.testing.assert_allclose(theta.numpy(), np.asarray(theta_j), rtol=1e-5)
    _assert_vecs_up_to_sign(U.numpy(), np.asarray(U_j))
    assert _residual_ratio(A, theta, U) < 1.0


def test_lobpcg_stops_at_m():
    """``m`` caps the loop: what the capped loop returns is JAX's after as
    many iterations, not yet converged."""
    A, X0 = MATRICES["zeros"](200), _start(200, 5)
    theta3, U3, iters3 = lobpcg_standard(torch.tensor(A), torch.tensor(X0), m=3)
    theta3_j, _, iters3_j = jax_lobpcg(jnp.asarray(A), jnp.asarray(X0), m=3)
    assert iters3 == int(iters3_j) == 3
    np.testing.assert_allclose(theta3.numpy(), np.asarray(theta3_j), rtol=1e-5)
    assert _residual_ratio(A, theta3, U3) > 1.0


def test_lobpcg_input_errors():
    A = torch.tensor(MATRICES["separated"](60))
    with pytest.raises(ValueError, match="search dim \\* 5 < matrix dim"):
        lobpcg_standard(A, torch.ones(60, 12))
    with pytest.raises(ValueError, match="search dim > 0"):
        lobpcg_standard(A, torch.ones(60, 0))
    with pytest.raises(ValueError, match="same dtypes"):
        lobpcg_standard(A.double(), torch.ones(60, 2))
    with pytest.raises(ValueError, match="matrix A"):
        lobpcg_standard(A[:50, :50], torch.ones(60, 2))
    with pytest.raises(ValueError, match="search dim \\* 5"):
        topk_eigh(A[:20, :20], 4, solver="lobpcg")


def test_svqb_matches_jax_and_truncates():
    """Full rank: JAX's basis up to column sign.  Rank-deficient (a zero
    column and a column repeated at twice its scale): the lost directions
    come back as zero columns, the rest orthonormal and spanning the input."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(50, 6)).astype(np.float32)
    got = _svqb(torch.tensor(X)).numpy()
    _assert_vecs_up_to_sign(got, np.asarray(jax_svqb(jnp.asarray(X))))
    np.testing.assert_allclose(got.T @ got, np.eye(6), atol=1e-5)

    X[:, 4] = 0.0
    X[:, 5] = 2.0 * X[:, 0]
    got = _svqb(torch.tensor(X)).numpy()
    want = np.asarray(jax_svqb(jnp.asarray(X)))
    zero = np.all(got == 0.0, axis=0)
    assert zero.sum() == 2 and np.array_equal(zero, np.all(want == 0.0, axis=0))
    kept = got[:, ~zero]
    np.testing.assert_allclose(kept.T @ kept, np.eye(4), atol=1e-5)
    proj = kept @ (kept.T @ X)  # the input's columns lie in the kept span
    np.testing.assert_allclose(proj, X, atol=1e-5 * np.abs(X).max())


def test_extend_basis_matches_jax():
    """``m`` columns orthonormal and orthogonal to ``X``, equal to JAX's
    (the block Householder reflector does not depend on the SVD's signs)."""
    rng = np.random.default_rng(1)
    X = np.linalg.qr(rng.normal(size=(40, 5)))[0].astype(np.float32)
    got = _extend_basis(torch.tensor(X), 5).numpy()
    want = np.asarray(jax_extend_basis(jnp.asarray(X), 5))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.T @ got, np.eye(5), atol=1e-5)
    assert np.abs(X.T @ got).max() < 1e-5


def _assert_evals(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = ATOL * np.abs(want).max() + RTOL * np.abs(want)
    err = np.abs(got - want)
    assert (err <= tol).all(), f"max err/tol {(err / tol).max():.2f}"


@pytest.mark.parametrize("name,n,k", [("separated", 300, 10), ("zeros", 200, 5)])
def test_topk_eigh_lobpcg_against_float64(name, n, k):
    A = MATRICES[name](n)
    ev, vecs, info = topk_eigh(torch.tensor(A), k, solver="lobpcg", return_info=True)
    assert vecs.shape == (n, k) and not bool(info["tripped"])
    assert bool((ev[1:] >= ev[:-1]).all())  # ascending
    ref, ref_vecs = np.linalg.eigh(A.astype(np.float64))
    _assert_evals(ev.numpy(), ref[-k:])
    _assert_vecs_up_to_sign(vecs.numpy(), ref_vecs[:, -k:])


def test_deflated_topk_eigh_lobpcg_against_float64():
    """The deflated CE Gram's top-k by LOBPCG, lifted: the full Gram's
    top-k (here (C−1)·S = 171 ≥ 5k); ``lobpcg_iters`` reaches the loop."""
    s, c, k = 19, 10, 8
    gram, p = _ce_gram(s, c, 400, seed=2)
    ev, vecs = deflate.deflated_topk_eigh(torch.tensor(gram), torch.tensor(p), k,
                                          solver="lobpcg")
    ref, ref_vecs = np.linalg.eigh(gram.astype(np.float64))
    _assert_evals(ev.numpy(), ref[-k:])
    _assert_vecs_up_to_sign(vecs.numpy(), ref_vecs[:, -k:])
    ev2, _ = deflate.deflated_topk_eigh(torch.tensor(gram), torch.tensor(p), k,
                                        solver="lobpcg", lobpcg_iters=2)
    assert not np.allclose(ev2.numpy(), ev.numpy(), rtol=1e-7, atol=0)
