"""Top-k eigenpairs of a symmetric matrix by LOBPCG (the port's copy of
``jax.experimental.sparse.linalg.lobpcg_standard``, which the JAX package's
``eig.topk_eigh(solver="lobpcg")`` calls).

The algorithm is JAX's, piece for piece: an orthonormal block ``[X, P, R]``
kept by SVQB with "twice is enough" re-orthonormalization, residuals projected
out of ``[X, P]`` with the final ``‖u‖ ≥ 0.99`` mask, Rayleigh-Ritz on the
``3k``-wide block in descending order, the next search directions from a QR
of ``Q[:k, k:]ᵀ``, the start extended by block Householder reflectors, and
the convergence test ``‖r‖ < tol·10·n·(‖Ax‖ + θ)``.  Every product runs in
full f32 (JAX's ``_mm`` is ``Precision.HIGHEST``).

The JAX loop is a device ``while_loop``; here each iteration reads the number
of converged pairs on the host once, so the loop stops at the same iteration.
"""

import torch

from vivit_tpu_torch.precision import full_f32


def lobpcg_standard(A: torch.Tensor, X: torch.Tensor, m: int = 100, tol=None):
    """Top-``k`` eigenpairs of the symmetric ``A [n, n]`` from the start
    block ``X [n, k]``.

    ``k·5 < n`` is required.  ``m`` caps the iterations; ``tol`` defaults to
    the float epsilon of ``X``'s dtype.  Returns ``(theta [k], U [n, k],
    iterations)``; ``theta`` is in the order of the Rayleigh-Ritz solve
    (descending), and is what ``m`` iterations give whether or not every
    pair converged.
    """
    _check_inputs(A, X)
    n, k = X.shape
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)

    with full_f32():
        X = _orthonormalize(X)
        P = _extend_basis(X, k)
        AX = A @ X
        theta = torch.sum(X * AX, dim=0, keepdim=True)
        R = AX - theta * X

        i, converged = 0, 0
        while i < m and converged < k:
            R = _project_out(torch.cat((X, P), dim=1), R)
            XPR = torch.cat((X, P, R), dim=1)
            theta, Q = _rayleigh_ritz_orth(A, XPR)

            B = Q[:, :k]
            B = B / torch.linalg.vector_norm(B, dim=0, keepdim=True)
            X = XPR @ B
            X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)

            q, _ = torch.linalg.qr(Q[:k, k:].T)
            P = XPR @ (Q[:, k:] @ q)
            normP = torch.linalg.vector_norm(P, dim=0, keepdim=True)
            P = P / torch.where(normP == 0, 1.0, normP)

            AX = A @ X
            R = AX - theta[None, :k] * X
            resid = torch.linalg.vector_norm(R, dim=0)
            reltol = (torch.linalg.vector_norm(AX, dim=0) + theta[:k]) * n * 10
            converged = int(torch.sum(resid < tol * reltol))  # one host read
            theta = theta[None, :k]
            i += 1
    return theta[0], X, i


def _check_inputs(A: torch.Tensor, X: torch.Tensor) -> None:
    """``0 < k``, ``5·k < n``; ``A`` ``[n, n]`` of ``X``'s dtype."""
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    if A.dtype != X.dtype:
        raise ValueError(f"A, X must have same dtypes (were {A.dtype}, {X.dtype})")
    if tuple(A.shape) != (n, n):
        raise ValueError(f"A must be ({n}, {n}) matrix A, got {tuple(A.shape)}")


def _eigh_descending(S: torch.Tensor):
    """``torch.linalg.eigh`` with the order reversed (JAX's misnamed
    ``_eigh_ascending``)."""
    w, V = torch.linalg.eigh(S)
    return w.flip(0), V.flip(1)


def _svqb(X: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of the columns of ``X`` by SVQB; directions whose
    Gram eigenvalue falls below ``eps·w_max`` come back as zero columns."""
    norms = torch.linalg.vector_norm(X, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** -0.5
    ortho = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = torch.linalg.vector_norm(ortho, dim=0, keepdim=True)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
    for _ in range(2):  # twice is enough
        basis = _svqb(basis)
    return basis


def _project_out(basis: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """The component of ``U`` orthogonal to the orthonormal (zero columns
    allowed) ``basis``; nonzero columns orthonormal, columns that lose more
    than 1% of their norm in the last subtraction zeroed."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    normU = torch.linalg.vector_norm(U, dim=0, keepdim=True)
    return U * (normU >= 0.99).to(U.dtype)


def _rayleigh_ritz_orth(A: torch.Tensor, S: torch.Tensor):
    """Eigenpairs of ``Sᵀ A S`` for an orthonormal ``S``, descending."""
    return _eigh_descending(S.T @ (A @ S))


def _extend_basis(X: torch.Tensor, m: int) -> torch.Tensor:
    """``m`` orthonormal columns orthogonal to the orthonormal ``X [n, k]``:
    columns ``k..k+m`` of the block Householder reflector that maps ``X`` to
    ``[-u vᵀ; 0]`` (``u s vᵀ`` the SVD of ``X``'s upper ``k × k`` block)."""
    n, k = X.shape
    upper, lower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(upper)
    y = torch.cat([upper + u @ vt, lower], dim=0)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       torch.zeros((n - k - m, m), dtype=X.dtype, device=X.device)])
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * (w @ (w[k:].T @ other))
    h[k:] += other
    return h
