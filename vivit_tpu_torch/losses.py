"""Losses with analytic loss-Hessian square roots (counterpart of
``vivit_tpu/losses.py``; cross-entropy only in this slice).

Conventions as in the JAX package: the per-sample loss ``ℓ_n`` is the loss
of the single sample, and the total loss is ``L = ρ Σ_n ℓ_n`` with
``ρ = 1/N`` (mean) or ``1`` (sum).  Functions take batched tensors: the
model output ``f`` is ``[S, C]``.
"""

import torch
import torch.nn.functional as F


class Loss:
    """Base class: reduction bookkeeping."""

    def __init__(self, reduction: str = "mean"):
        if reduction not in ("mean", "sum"):
            raise ValueError(f"reduction must be 'mean' or 'sum', got {reduction!r}")
        self.reduction = reduction

    def per_sample(self, f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Per-sample losses ``ℓ_n``."""
        raise NotImplementedError

    def __call__(self, f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        ell = self.per_sample(f, y)
        return ell.mean() if self.reduction == "mean" else ell.sum()

    def rho(self, batch_size: int) -> float:
        """Reduction weight ``ρ`` with ``L = ρ Σ_n ℓ_n``."""
        return 1.0 / batch_size if self.reduction == "mean" else 1.0

    def sqrt_hessian(self, f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Exact factors ``[S, C, C]``: rows ``s_c`` of sample ``n`` satisfy
        ``∂²ℓ_n/∂f² = Σ_c s_c s_cᵀ``."""
        raise NotImplementedError(
            f"{type(self).__name__} has no analytic factorization in the port yet."
        )


class CrossEntropyLoss(Loss):
    """Softmax cross-entropy with integer targets.

    Per-sample Hessian w.r.t. the logits: ``diag(p) − p pᵀ`` with
    ``p = softmax(f)``; exact factor rows ``s_c = √p_c (e_c − p)``.
    """

    def per_sample(self, f, y):
        logp = F.log_softmax(f, dim=-1)
        return -logp.gather(-1, y.long()[:, None])[:, 0]

    def sqrt_hessian(self, f, y):
        p = torch.softmax(f, dim=-1)
        eye = torch.eye(f.shape[-1], dtype=f.dtype, device=f.device)
        return p.sqrt()[..., :, None] * (eye - p[..., None, :])
