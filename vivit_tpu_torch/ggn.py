"""Loss-factor front half of the V-transform and per-sample gradients
(counterpart of ``vivit_tpu/ggn.py``; the exact branch and ``batch_grad``
only in this slice).

The GGN ``G = ρ Σ_n J_nᵀ H_n J_n = V Vᵀ`` has columns
``v_{n,c} = √ρ · J_nᵀ s_{n,c}`` for the factorization ``H_n = Σ_c s_c s_cᵀ``.
:func:`v_factors` produces the scaled (optionally CE-deflated) ``s_{n,c}``
that the tapped backward (:mod:`vivit_tpu_torch.tapped`) pulls back.
"""

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from vivit_tpu_torch.losses import Loss
from vivit_tpu_torch.utils.checks import check_subsampling_unique


def v_factors(loss: Loss, f: torch.Tensor, y: torch.Tensor, *,
              batch_size: int, deflate_ce_null: bool = False) -> torch.Tensor:
    """Scaled (optionally CE-deflated) loss factors ``[S, CF', C]``.

    The factors are the exact loss-Hessian square roots
    (``loss.sqrt_hessian``: the exact branch of the JAX package's
    ``loss_hessian_sqrt``; Monte-Carlo factors are not ported yet).  The
    column scale ``√(ρ(N)·N/S)`` is folded in; with ``deflate_ce_null`` the
    factor rows are projected onto the CE null complement (``CF' = C − 1``).
    The projection runs in full f32.
    """
    S = f.shape[0]
    factors = loss.sqrt_hessian(f, y)
    scale = (loss.rho(batch_size) * batch_size / S) ** 0.5
    factors = factors * scale
    if deflate_ce_null:
        from vivit_tpu_torch.deflate import ce_null_complement
        from vivit_tpu_torch.precision import full_f32

        w = ce_null_complement(torch.softmax(f, dim=-1))
        with full_f32():
            factors = torch.einsum("sca,sck->sak", w, factors)
    return factors


def batch_grad(module: nn.Module, loss: Loss, X: torch.Tensor, y: torch.Tensor, *,
               subsampling: Optional[Sequence[int]] = None,
               batch_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Per-sample gradients ``ρ·∇ℓ_n`` as ``{parameter name: [S, *shape]}``.

    BackPACK's ``BatchGrad`` scaling, as in the JAX package: for mean
    reduction each gradient carries the ``1/N`` factor (``N = batch_size``,
    default ``X.shape[0]``).  ``torch.func.vmap`` of ``torch.func.grad``
    over a one-sample ``functional_call``; full f32, so that cuDNN's
    convolutions do not fall to TF32.
    """
    from torch.func import functional_call, grad, vmap

    from vivit_tpu_torch.precision import full_f32

    check_subsampling_unique(subsampling)
    N = batch_size if batch_size is not None else X.shape[0]
    if subsampling is not None:
        idx = torch.as_tensor(list(subsampling), device=X.device)
        X, y = X[idx], y[idx]
    rho = loss.rho(N)
    params = {name: p.detach() for name, p in module.named_parameters()}

    def sample_loss(p, x_n, y_n):
        f_n = functional_call(module, p, (x_n[None],))
        return rho * loss.per_sample(f_n, y_n[None])[0]

    with full_f32():
        return vmap(grad(sample_loss), in_dims=(None, 0, 0))(params, X, y)
