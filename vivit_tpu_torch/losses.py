"""Losses with loss-Hessian square roots (counterpart of
``vivit_tpu/losses.py``).

Conventions as in the JAX package: the per-sample loss ``ℓ_n`` is the loss
of the single sample, and the total loss is ``L = ρ Σ_n ℓ_n`` with
``ρ = 1/N`` (mean) or ``1`` (sum).  Functions take batched tensors: the
model output ``f`` is ``[S, C]``.

Monte-Carlo factors come in two steps, so that a draw can be replayed:
:meth:`Loss.mc_draws` makes the random part of each sample from a CPU
``torch.Generator`` seeded by a fixed mix of ``(key, global sample id)``
(:func:`sample_generator`; ``key`` is an int) and moves it to the device in
one copy; :meth:`Loss.sqrt_hessian_mc` turns the draws into factors.  The
draws of a sample are therefore the same on the CPU and the card, and the
same whichever sub-batch or layout it arrives in.  They are not JAX's
``fold_in`` stream: the two packages draw different numbers.
"""

import warnings
from typing import Callable

import torch
import torch.nn.functional as F

from vivit_tpu_torch.utils.graphs import eager

_MASK64 = (1 << 64) - 1


def sample_generator(key: int, sample_id: int) -> torch.Generator:
    """CPU generator of one sample's Monte-Carlo draws: seeded by the
    splitmix64 finalizer of ``key·φ + sample_id`` (φ = 0x9E3779B97F4A7C15),
    so nearby keys and ids give unrelated streams."""
    x = (int(key) * 0x9E3779B97F4A7C15 + int(sample_id)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return torch.Generator().manual_seed(x >> 1)


def _per_sample(key: int, sample_ids, draw: Callable[[torch.Generator], torch.Tensor],
                device) -> torch.Tensor:
    """``draw(generator)`` for each sample id, stacked on the CPU, moved to
    ``device`` in one copy."""
    ids = torch.as_tensor(sample_ids).reshape(-1).tolist()
    return torch.stack([draw(sample_generator(key, i)) for i in ids]).to(device)


class Loss:
    """Base class: reduction bookkeeping plus generic autodiff fallbacks."""

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
        ``∂²ℓ_n/∂f² = Σ_c s_c s_cᵀ``.

        Generic fallback: the per-sample loss Hessian by
        ``torch.func.hessian``, eigendecomposed, its eigenvalues clipped at 0
        (a PSD projection for convex losses); ``O(S·C³)``.  Defined up to a
        rotation of the rows: compare ``SᵀS``, not ``S``.
        """
        from torch.func import hessian, vmap

        c = f.shape[-1]
        if c > 128:
            warnings.warn(
                f"Generic sqrt_hessian eigendecomposes a [{c}, {c}] "
                f"per-sample loss Hessian for every sample — O(N·C³). For large "
                f"output dimensions provide an analytic factorization "
                f"(override sqrt_hessian) or use MC sampling.",
                stacklevel=2,
            )

        def sample_loss(f_n, y_n):
            return self.per_sample(f_n[None], y_n[None])[0]

        hess = vmap(hessian(sample_loss))(f, y)
        evals, evecs = eager(torch.linalg.eigh, hess)  # a vendor step when captured
        root = evecs * evals.clamp(min=0.0).sqrt()[..., None, :]
        return root.transpose(-1, -2)

    def mc_draws(self, f: torch.Tensor, y: torch.Tensor, mc_samples: int, key: int,
                 sample_ids) -> torch.Tensor:
        """The random part of the Monte-Carlo factors of each sample, drawn
        from :func:`sample_generator` ``(key, sample_ids[n])``."""
        raise NotImplementedError(f"{type(self).__name__} does not support MC sampling.")

    def sqrt_hessian_mc(self, f: torch.Tensor, y: torch.Tensor,
                        draws: torch.Tensor) -> torch.Tensor:
        """MC factors ``[S, M, C]`` from :meth:`mc_draws`, with
        ``E[Σ_m s̃_m s̃_mᵀ] = ∂²ℓ_n/∂f²``."""
        raise NotImplementedError(f"{type(self).__name__} does not support MC sampling.")

    def hessian_vp(self, f: torch.Tensor, y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``(∂²L/∂f²) t`` of the total loss, for batched ``f`` and tangent
        ``t``: forward over reverse (``torch.func`` jvp of grad)."""
        from torch.func import grad, jvp

        return jvp(grad(lambda ff: self(ff, y)), (f,), (t,))[1]


class MSELoss(Loss):
    """Mean squared error with torch ``MSELoss`` semantics.

    ``reduction="mean"``: ``L = 1/(N·C) Σ_{n,c} (f − y)²``; ``"sum"``:
    ``L = Σ_{n,c} (f − y)²``.  Per-sample Hessian ``h·I`` with ``h = 2/C``
    (mean) or ``2`` (sum).
    """

    def per_sample(self, f, y):
        sq = ((f - y) ** 2).reshape(f.shape[0], -1)
        per = sq.sum(dim=1)
        return per / sq.shape[1] if self.reduction == "mean" else per

    def _h(self, num_classes: int) -> float:
        return 2.0 / num_classes if self.reduction == "mean" else 2.0

    def sqrt_hessian(self, f, y):
        s, c = f.shape
        eye = torch.eye(c, dtype=f.dtype, device=f.device)
        return (self._h(c) ** 0.5 * eye).expand(s, c, c)

    def mc_draws(self, f, y, mc_samples, key, sample_ids):
        """Standard normal ``ε [S, M, C]``."""
        c = f.shape[-1]
        return _per_sample(key, sample_ids, lambda g: torch.randn(
            (mc_samples, c), generator=g, dtype=f.dtype), f.device)

    def sqrt_hessian_mc(self, f, y, draws):
        c, m = f.shape[-1], draws.shape[1]
        return (self._h(c) / m) ** 0.5 * draws

    def hessian_vp(self, f, y, t):
        n = f.shape[0]
        c = f.numel() // n
        scale = 2.0 / (n * c) if self.reduction == "mean" else 2.0
        return scale * t


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

    def mc_draws(self, f, y, mc_samples, key, sample_ids):
        """Sampled labels ``[S, M]`` from ``softmax(f)``: per-sample uniforms
        inverted through the cumulative probabilities."""
        u = _per_sample(key, sample_ids, lambda g: torch.rand(
            (mc_samples,), generator=g, dtype=torch.float64), f.device)
        cdf = torch.softmax(f.double(), dim=-1).cumsum(dim=-1)
        labels = torch.searchsorted(cdf, u, right=True)
        return labels.clamp(max=f.shape[-1] - 1)

    def sqrt_hessian_mc(self, f, y, draws):
        """``s̃_m = (p − e_ỹm)/√M``: the gradient of ``ℓ(f, ỹ_m)`` at the
        sampled label ``ỹ_m = draws[:, m]``."""
        p = torch.softmax(f, dim=-1)
        onehot = F.one_hot(draws.long(), f.shape[-1]).to(f.dtype)
        return (p[:, None, :] - onehot) / draws.shape[1] ** 0.5

    def hessian_vp(self, f, y, t):
        p = torch.softmax(f, dim=-1)
        hv = p * t - p * (p * t).sum(dim=-1, keepdim=True)
        return hv / f.shape[0] if self.reduction == "mean" else hv


class CustomLoss(Loss):
    """An arbitrary convex per-sample loss ``ℓ(f_n, y_n) -> scalar``.

    The exact factor comes from the generic eigendecomposition of the
    per-sample Hessian (:meth:`Loss.sqrt_hessian`); MC sampling is
    unavailable.
    """

    def __init__(self, per_sample_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 reduction: str = "mean"):
        super().__init__(reduction)
        self._fn = per_sample_fn

    def per_sample(self, f, y):
        from torch.func import vmap

        return vmap(self._fn)(f, y)


__all__ = ["CrossEntropyLoss", "CustomLoss", "Loss", "MSELoss", "sample_generator"]
