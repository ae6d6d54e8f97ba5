"""Full-spectrum symmetric eigensolver dispatch (counterpart of
``vivit_tpu/eig.py``; ``full_eigh`` only in this slice)."""

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
