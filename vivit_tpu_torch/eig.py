"""Symmetric eigensolver dispatch (counterpart of ``vivit_tpu/eig.py``;
``full_eigh`` and ``topk_eigh``)."""

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
    return_info: bool = False,
):
    """Full-spectrum symmetric eigendecomposition, ascending.

    ``backend="xla"`` is the vendor solver (``torch.linalg.eigh``; the name
    is kept so call sites read as in the JAX package).  ``backend="dc"`` is
    the spectral divide-and-conquer solver (:mod:`vivit_tpu_torch.eigdc`).
    Returns ``(evals, evecs or None[, info])``.
    """
    if backend == "dc":
        from vivit_tpu_torch.eigdc import eigh_dc

        return eigh_dc(gram, eigenvectors=eigenvectors, return_info=return_info)
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
