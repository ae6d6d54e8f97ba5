"""Lanczos spectral-density estimation, stochastic Lanczos quadrature
(counterpart of ``vivit_tpu/hessianfree/lanczos.py``).

Algorithm 2 and the density estimator of Papyan, "Traces of
Class/Cross-Class Structure Pervade Deep Learning Spectra": Lanczos without
reorthogonalization, Gaussian-smoothed quadrature on the spectrum rescaled
to ``[-1, 1]``.

* :func:`fast_lanczos` and the density estimators are numpy and SciPy over
  anything with ``A @ v`` (the operators of :mod:`vivit_tpu_torch.hessianfree`
  included), the JAX package's code kept as its own copy here;
* :func:`fast_lanczos_jax` keeps the JAX package's name: nothing in it is
  JAX.  It is a loop on the device over a device matvec
  (:func:`vivit_tpu_torch.hessianfree.ggn_operator`) with no host read
  inside the sweep, then ``torch.linalg.eigh`` of the small tridiagonal.
"""

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def fast_lanczos(A, ncv: int, seed: Optional[int] = None,
                 use_eigh_tridiagonal: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Lanczos without reorthogonalization on the host.

    ``A`` is a symmetric operator with ``A @ v`` and ``A.shape``; ``ncv``
    the number of Lanczos vectors; ``seed`` seeds the normal start vector
    (``None``: fresh entropy); ``use_eigh_tridiagonal`` picks SciPy's faster,
    less stable tridiagonal solver.  Returns the eigenvalues and eigenvectors
    of the Krylov tridiagonal matrix, ``evecs[:, i]`` belonging to
    ``evals[i]``.
    """
    rng = np.random.default_rng(seed)
    dim = A.shape[1]
    alphas, betas = np.zeros(ncv), np.zeros(ncv - 1)

    v = rng.standard_normal(dim)
    v /= np.linalg.norm(v)
    v_prev = None
    for m in range(ncv):
        v_next = A @ v if m == 0 else A @ v - betas[m - 1] * v_prev
        alphas[m] = np.inner(v_next, v)
        v_next = v_next - alphas[m] * v
        if m < ncv - 1:
            betas[m] = np.linalg.norm(v_next)
            v_prev, v = v, v_next / betas[m]

    if use_eigh_tridiagonal:
        from scipy.linalg import eigh_tridiagonal

        return eigh_tridiagonal(alphas, betas)
    T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
    return np.linalg.eigh(T)


def fast_lanczos_jax(matvec: Callable[[torch.Tensor], torch.Tensor], dim: int, ncv: int,
                     key: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lanczos sweep on the device: the eigendecomposition of the Krylov
    tridiagonal, as :func:`fast_lanczos` returns it, from ``ncv`` device
    matvecs with no host read in between.  The normal start vector comes
    from a ``torch.Generator`` on ``device`` (default the CUDA card) seeded
    with the int ``key``."""
    from vivit_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(key)
    v0 = torch.randn(dim, generator=gen, dtype=torch.float32, device=device)
    return _lanczos_from(matvec, v0 / torch.linalg.vector_norm(v0), ncv)


def _lanczos_from(matvec, v0: torch.Tensor, ncv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sweep of :func:`fast_lanczos_jax` from the unit start vector
    ``v0``; a zero ``β`` (an invariant subspace) leaves the next vector 0."""
    v, v_prev, beta_prev = v0, torch.zeros_like(v0), v0.new_zeros(())
    alphas, betas = [], []
    for _ in range(ncv):
        v_next = matvec(v) - beta_prev * v_prev
        alpha = torch.dot(v_next, v)
        v_next = v_next - alpha * v
        beta = torch.linalg.vector_norm(v_next)
        safe = torch.where(beta > 0, beta, torch.ones_like(beta))
        v_prev, v, beta_prev = v, v_next / safe, beta
        alphas.append(alpha)
        betas.append(beta)
    alphas, betas = torch.stack(alphas), torch.stack(betas[:-1])
    T = torch.diag(alphas) + torch.diag(betas, 1) + torch.diag(betas, -1)
    return torch.linalg.eigh(T)


def _as_scipy(A):
    """The operator wrappers of this package go into ARPACK directly: they
    expose ``as_scipy()``."""
    return A.as_scipy() if hasattr(A, "as_scipy") else A


def approximate_boundaries(A, tol: float = 1e-2) -> Tuple[float, float]:
    """``(λ_min(A), λ_max(A))`` by ARPACK."""
    from scipy.sparse.linalg import eigsh

    eval_min, eval_max = eigsh(_as_scipy(A), k=2, which="BE", tol=tol,
                               return_eigenvectors=False)
    return eval_min, eval_max


def approximate_boundaries_abs(A, tol: float = 1e-2) -> Tuple[float, float]:
    """``(λ_min(|A|), λ_max(|A|))`` by ARPACK."""
    from scipy.sparse.linalg import eigsh

    A = _as_scipy(A)
    (eval_max,) = eigsh(A, k=1, which="LM", tol=tol, return_eigenvectors=False)
    (eval_min,) = eigsh(A, k=1, which="SM", tol=tol, return_eigenvectors=False)
    return abs(eval_min), abs(eval_max)


def _gaussian(x, mu, sigma):
    return np.exp(-0.5 * ((x - mu) / sigma) ** 2) / (sigma * np.sqrt(2 * np.pi))


def lanczos_approximate_spectrum(
    A,
    ncv: int,
    num_points: int = 1024,
    num_repeats: int = 1,
    kappa: float = 3.0,
    boundaries: Optional[Tuple[float, float]] = None,
    margin: float = 0.05,
    boundaries_tol: float = 1e-2,
    seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian-smoothed spectral density ``p(λ) = 1/d Σ δ(λ − λ_i)`` on a
    grid of ``num_points``: the spectrum rescaled to ``[-1, 1]`` (the bump
    width ``kappa`` needs no tuning per problem), quadrature weights the
    squared first components of the Krylov eigenvectors, averaged over
    ``num_repeats`` start vectors.  ``boundaries`` default to ARPACK's."""
    if boundaries is None:
        boundaries = approximate_boundaries(A, tol=boundaries_tol)
    eval_min, eval_max = boundaries
    pad = margin * (eval_max - eval_min)
    eval_min, eval_max = eval_min - pad, eval_max + pad
    c, d = (eval_max + eval_min) / 2, (eval_max - eval_min) / 2

    grid_norm = np.linspace(-1, 1, num_points, endpoint=True)
    grid_out = grid_norm * d + c
    sigma = 2 / (ncv - 1) / np.sqrt(8 * np.log(kappa))

    density = np.zeros_like(grid_norm)
    rng = np.random.default_rng(seed)
    for _ in range(num_repeats):
        evals, evecs = fast_lanczos(A, ncv, seed=int(rng.integers(2**31)))
        nodes = (evals - c) / d
        weights = evecs[0, :] ** 2 / d
        density += (
            weights[:, None] * _gaussian(grid_norm[None, :], nodes[:, None], sigma)
        ).sum(0) / num_repeats
    return grid_out, density


def lanczos_approximate_log_spectrum(
    A,
    ncv: int,
    num_points: int = 1024,
    num_repeats: int = 1,
    kappa: float = 1.04,
    boundaries: Optional[Tuple[float, float]] = None,
    margin: float = 0.05,
    boundaries_tol: float = 1e-2,
    epsilon: float = 1e-5,
    seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Spectral density of ``log(|A| + ε I)`` (``boundaries`` default to
    ARPACK's of ``|A|``)."""
    if boundaries is None:
        boundaries = approximate_boundaries_abs(A, tol=boundaries_tol)
    log_min, log_max = (np.log(b + epsilon) for b in boundaries)
    pad = margin * (log_max - log_min)
    log_min, log_max = log_min - pad, log_max + pad
    c, d = (log_max + log_min) / 2, (log_max - log_min) / 2

    grid_norm = np.linspace(-1, 1, num_points, endpoint=True)
    grid_out = np.exp(grid_norm * d + c)
    sigma = 2 / (ncv - 1) / np.sqrt(8 * np.log(kappa))

    density = np.zeros_like(grid_norm)
    rng = np.random.default_rng(seed)
    for _ in range(num_repeats):
        evals, evecs = fast_lanczos(A, ncv, seed=int(rng.integers(2**31)))
        nodes = (np.log(np.abs(evals) + epsilon) - c) / d
        weights = evecs[0, :] ** 2
        density += (
            weights[:, None] * _gaussian(grid_norm[None, :], nodes[:, None], sigma)
        ).sum(0) / num_repeats
    density /= d * grid_out
    return grid_out, density
