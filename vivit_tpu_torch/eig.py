"""Symmetric eigensolver dispatch (counterpart of ``vivit_tpu/eig.py``;
``full_eigh`` and ``topk_eigh`` in this slice)."""

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
              return_info: bool = False):
    """Top-``k`` eigenpairs of a PSD Gram: ``(evals [k] ascending,
    evecs [dim, k][, info])``.

    ``solver="eigh"`` slices ``torch.linalg.eigh``; ``solver="dc"`` slices
    the spectral divide-and-conquer decomposition, and ``info`` is its guard
    info (all zeros otherwise).  ``"lobpcg"`` is not ported yet.
    """
    if solver == "eigh":
        evals, evecs = torch.linalg.eigh(gram)
        info = no_trip_info(gram.device)
    elif solver == "dc":
        from vivit_tpu_torch.eigdc import eigh_dc

        evals, evecs, info = eigh_dc(gram, return_info=True)
    elif solver == "lobpcg":
        raise NotImplementedError(
            "topk_eigh(solver='lobpcg') is not ported yet (ROADMAP queue 1 "
            "item 3); use solver='eigh' or 'dc'."
        )
    else:
        raise ValueError(f"Unknown solver {solver!r} (use 'eigh', 'lobpcg' or 'dc').")
    out = (evals[-k:], evecs[:, -k:])
    return (*out, info) if return_info else out
