"""Analytic null-space deflation of the cross-entropy GGN (counterpart of
``vivit_tpu/deflate.py``; the factor-level pieces only in this slice).

For exact CE factors ``s_{n,c} = √p_c (e_c − p)`` each sample's factor rows
satisfy ``Σ_c √p_{n,c} s_{n,c} = 0``, so the ``[CS, CS]`` Gram carries ``S``
structural zero eigenvalues.  Projecting the factor rows onto the orthogonal
complement of ``√p_n`` before the backward shrinks the Gram to
``[(C−1)S, (C−1)S]`` exactly.
"""

import torch


def ce_null_complement(probs: torch.Tensor) -> torch.Tensor:
    """Orthonormal complement of the per-sample CE null vectors.

    ``probs [S, C]`` → ``W [S, C, C−1]`` with ``W[n].T @ √p_n = 0``: the
    columns ``1..C−1`` of the Householder reflector
    ``I − v vᵀ/(1+u₁)``, ``u = √p``, ``v = u + e₁``.
    """
    u = probs.sqrt()
    c = u.shape[-1]
    e1 = torch.zeros(c, dtype=u.dtype, device=u.device)
    e1[0] = 1.0
    v = u + e1
    beta = 1.0 / (1.0 + u[:, 0])
    eye = torch.eye(c, dtype=u.dtype, device=u.device)
    h = eye[None] - beta[:, None, None] * (v[:, :, None] * v[:, None, :])
    return h[:, :, 1:]


def check_deflatable(loss) -> None:
    """Raise unless the exact-CE null structure applies (the port computes
    exact factors only)."""
    from vivit_tpu_torch.losses import CrossEntropyLoss

    if not isinstance(loss, CrossEntropyLoss):
        raise ValueError(
            "CE null-space deflation applies to CrossEntropyLoss only "
            f"(got {type(loss).__name__}); MSE factors are full-rank."
        )
