"""Symmetric eigensolver dispatch and the stability helpers (counterpart of
``vivit_tpu/eig.py``): ``full_eigh``, ``topk_eigh``, diagonal shifting for
nearly singular PSD matrices and zero-eigenvalue filtering.  Eigenvalues
ascend; eigenvectors are columns."""

from typing import Optional, Tuple

import torch


def no_trip_info(device=None) -> dict:
    """Guard-info constant for eigensolves that cannot trip a guard (same
    keys as :func:`vivit_tpu_torch.eigdc.eigh_dc`'s info)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"tripped": torch.zeros((), dtype=torch.bool, device=device),
            "bound": z, "orth": z.clone()}


def full_eigh(
    gram: torch.Tensor,
    *,
    backend: str = "xla",
    eigenvectors: bool = True,
    key: Optional[int] = None,
    return_info: bool = False,
):
    """Full-spectrum symmetric eigendecomposition, ascending.

    ``backend="xla"`` is the vendor solver (``torch.linalg.eigh``; the name
    is kept so call sites read as in the JAX package).  ``backend="dc"`` is
    the spectral divide-and-conquer solver (:mod:`vivit_tpu_torch.eigdc`),
    its draws seeded with the int ``key``.  Returns ``(evals, evecs or
    None[, info])``.
    """
    if backend == "dc":
        from vivit_tpu_torch.eigdc import eigh_dc

        return eigh_dc(gram, eigenvectors=eigenvectors, key=key,
                       return_info=return_info)
    if backend != "xla":
        raise ValueError(f"Unknown eig backend {backend!r} (use 'xla' or 'dc').")
    if eigenvectors:
        evals, evecs = torch.linalg.eigh(gram)
    else:
        evals, evecs = torch.linalg.eigvalsh(gram), None
    if return_info:
        return evals, evecs, no_trip_info(gram.device)
    return evals, evecs


def topk_eigh(gram: torch.Tensor, k: int, solver: str = "eigh",
              lobpcg_iters: int = 100, return_info: bool = False):
    """Top-``k`` eigenpairs of a PSD Gram: ``(evals [k] ascending,
    evecs [dim, k][, info])``.

    ``solver="eigh"`` slices ``torch.linalg.eigh``; ``solver="dc"`` slices
    the spectral divide-and-conquer decomposition, and ``info`` is its guard
    info (all zeros otherwise).  ``solver="lobpcg"`` runs at most
    ``lobpcg_iters`` LOBPCG iterations (:mod:`vivit_tpu_torch.lobpcg`;
    ``5·k < dim``) from a normal start block drawn from a generator on the
    Gram's device seeded with ``k``.
    """
    if solver == "eigh":
        evals, evecs = torch.linalg.eigh(gram)
        info = no_trip_info(gram.device)
    elif solver == "dc":
        from vivit_tpu_torch.eigdc import eigh_dc

        evals, evecs, info = eigh_dc(gram, return_info=True)
    elif solver == "lobpcg":
        from vivit_tpu_torch.lobpcg import lobpcg_standard

        gen = torch.Generator(device=gram.device).manual_seed(k)
        x0 = torch.randn((gram.shape[0], k), generator=gen, dtype=gram.dtype,
                         device=gram.device)
        theta, u, _ = lobpcg_standard(gram, x0, m=lobpcg_iters)
        order = torch.argsort(theta)  # the Rayleigh-Ritz order is descending
        out = (theta[order], u[:, order])
        return (*out, no_trip_info(gram.device)) if return_info else out
    else:
        raise ValueError(f"Unknown solver {solver!r} (use 'eigh', 'lobpcg' or 'dc').")
    out = (evals[-k:], evecs[:, -k:])
    return (*out, info) if return_info else out


def shift_diag(mat: torch.Tensor, shift: float) -> torch.Tensor:
    """``mat`` with ``shift`` added to its diagonal (a new tensor)."""
    if shift == 0.0:
        return mat
    n = min(mat.shape)
    return mat + shift * torch.eye(n, dtype=mat.dtype, device=mat.device)


def symeig_psd(mat: torch.Tensor, shift: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(evals ascending, evecs)`` of a PSD symmetric matrix, decomposed
    with ``shift`` on its diagonal (a better condition number for nearly
    singular Grams) and the shift taken off the eigenvalues."""
    if mat.dim() != 2:
        raise ValueError(f"Input must have dimension 2. Got {mat.dim()}.")
    evals, evecs = torch.linalg.eigh(shift_diag(mat, shift))
    return evals - shift, evecs


def symeig(mat: torch.Tensor, eigenvectors: bool = False, atol: float = 1e-7,
           rtol: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecompose and drop the pairs whose eigenvalue is numerically
    zero (:func:`remove_zero_evals`, a host-side filter).  Raises
    ``RuntimeError`` if an eigenvalue is NaN; without ``eigenvectors`` the
    vectors come back empty."""
    if mat.dim() != 2:
        raise ValueError("Input must be of dimension 2")
    evals, evecs = torch.linalg.eigh(mat)
    if bool(torch.isnan(evals).any()):
        raise RuntimeError("Eigendecomposition produced NaNs (input may contain NaNs).")
    if not eigenvectors:
        evecs = torch.zeros((0,), dtype=mat.dtype, device=mat.device)
    return remove_zero_evals(evals, evecs, atol=atol, rtol=rtol)


def remove_zero_evals(evals: torch.Tensor, evecs: torch.Tensor, atol: float = 1e-7,
                      rtol: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop the ``(eval, evec)`` pairs whose eigenvalue is close to zero;
    the mask is read on the host once (the result's shape depends on it)."""
    nonzero = ~torch.isclose(evals, torch.zeros_like(evals), rtol=rtol, atol=atol)
    keep = torch.nonzero(nonzero.cpu()).flatten().to(evals.device)
    evals = evals[keep]
    if evecs.numel() != 0:
        evecs = evecs[:, keep]
    return evals, evecs
