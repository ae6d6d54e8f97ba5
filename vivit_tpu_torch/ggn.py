"""Loss-factor front half of the V-transform (counterpart of
``vivit_tpu/ggn.py``; the exact branch only in this slice).

The GGN ``G = ρ Σ_n J_nᵀ H_n J_n = V Vᵀ`` has columns
``v_{n,c} = √ρ · J_nᵀ s_{n,c}`` for the factorization ``H_n = Σ_c s_c s_cᵀ``.
:func:`v_factors` produces the scaled (optionally CE-deflated) ``s_{n,c}``
that the tapped backward (:mod:`vivit_tpu_torch.tapped`) pulls back.
"""

import torch

from vivit_tpu_torch.losses import Loss


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
