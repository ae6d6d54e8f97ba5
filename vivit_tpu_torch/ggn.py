"""The GGN square root as a function transform, per-sample gradients and
matrix-free curvature products (counterpart of ``vivit_tpu/ggn.py``).

The GGN ``G = ρ Σ_n J_nᵀ H_n J_n = V Vᵀ`` has columns
``v_{n,c} = √ρ · J_nᵀ s_{n,c}`` for the factorization ``H_n = Σ_c s_c s_cᵀ``.
:func:`v_factors` produces the scaled (optionally CE-deflated) ``s_{n,c}``;
:func:`ggn_sqrt_vt` pulls them back through any differentiable
``model_fn(params, X)`` (the generic engine), and the tapped engine
(:mod:`vivit_tpu_torch.tapped`) through an ``nn.Module``'s layers.

Models are ``model_fn(params, X) -> [N, C]`` over a parameter dict
``{name: Tensor}``; for an ``nn.Module`` that is
``torch.func.functional_call`` (:func:`vivit_tpu_torch.engines.forward_fn`).
"""

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from vivit_tpu_torch.losses import Loss
from vivit_tpu_torch.utils.checks import check_subsampling_unique
from vivit_tpu_torch.utils.graphs import constant

ModelFn = Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]


def _subsample(X, y, subsampling):
    """The rows ``subsampling`` of ``X`` and ``y``; the index tensor is a
    constant of a captured body (:func:`vivit_tpu_torch.utils.graphs.constant`),
    as a host-to-device copy cannot be captured."""
    if subsampling is None:
        return X, y
    idx = constant(lambda: torch.as_tensor(list(subsampling), device=X.device))
    return X[idx], y[idx]


def _sample_ids(X, subsampling, sample_ids):
    """The global sample ids of the MC draws: ``sample_ids``, else the
    ``subsampling`` indices, else ``0..N−1``."""
    if sample_ids is not None:
        return sample_ids
    return list(subsampling) if subsampling is not None else list(range(X.shape[0]))


def loss_hessian_sqrt(loss: Loss, f: torch.Tensor, y: torch.Tensor,
                      mc_samples: int = 0, key: Optional[int] = None,
                      sample_ids=None) -> torch.Tensor:
    """Per-sample loss-Hessian square-root factors ``[S, CF, C]`` (``[S,
    CF, T, V]`` over sequence logits): exact (``mc_samples == 0``, ``CF =
    C``, or ``T·V``) or Monte-Carlo (``CF = M``), whose
    draws are a function of ``(key, sample_ids[n])`` only
    (:mod:`vivit_tpu_torch.losses`), so any sub-batch or layout of the same
    samples draws the same numbers."""
    if mc_samples == 0:
        return loss.sqrt_hessian(f, y)
    if key is None:
        raise ValueError("mc_samples > 0 requires a PRNG `key`.")
    if sample_ids is None:
        sample_ids = range(f.shape[0])
    draws = loss.mc_draws(f, y, mc_samples, key, sample_ids)
    return loss.sqrt_hessian_mc(f, y, draws)


def v_factors(loss: Loss, f: torch.Tensor, y: torch.Tensor, *, batch_size: int,
              mc_samples: int = 0, key: Optional[int] = None, sample_ids=None,
              column_scale: Optional[float] = None,
              deflate_ce_null: bool = False) -> torch.Tensor:
    """Scaled (optionally CE-deflated) loss factors ``[S, CF', C]``, or
    ``[S, CF, T, V]`` over sequence logits ``[S, T, V]``.

    The shared front half of every V-transform engine: the loss-Hessian
    square roots (:func:`loss_hessian_sqrt`), the column scale
    ``√(ρ(N)·N/S)`` folded in (or ``column_scale``), and with
    ``deflate_ce_null`` (exact CE) the factor rows projected onto the CE null
    complement (``CF' = C − 1``).  The projection runs in full f32.
    """
    S = f.shape[0]
    if deflate_ce_null and f.dim() > 2:
        raise ValueError("CE null-space deflation takes [S, C] logits, got "
                         f"{tuple(f.shape)}")
    factors = loss_hessian_sqrt(loss, f, y, mc_samples=mc_samples, key=key,
                                sample_ids=sample_ids)
    if column_scale is None:
        column_scale = (loss.rho(batch_size) * batch_size / S) ** 0.5
    # sequence factors ([S, CF, T, V]) are scaled in place: they are fresh
    # and as large as the logits
    factors = factors.mul_(column_scale) if f.dim() > 2 else factors * column_scale
    if deflate_ce_null:
        from vivit_tpu_torch.deflate import ce_null_complement
        from vivit_tpu_torch.precision import full_f32

        w = ce_null_complement(torch.softmax(f, dim=-1))
        with full_f32():
            factors = torch.einsum("sca,sck->sak", w, factors)
    return factors


def ggn_sqrt_vt(
    model_fn: ModelFn,
    loss: Loss,
    params: Dict[str, torch.Tensor],
    X: torch.Tensor,
    y: torch.Tensor,
    *,
    subsampling: Optional[Sequence[int]] = None,
    mc_samples: int = 0,
    key: Optional[int] = None,
    batch_size: Optional[int] = None,
    column_scale: Optional[float] = None,
    sample_ids=None,
    deflate_ce_null: bool = False,
) -> Dict[str, torch.Tensor]:
    """``Vᵀ`` of any differentiable model, ``{name: [CF, S, *param.shape]}``
    (the generic engine).

    Each sample's columns ``J_nᵀ s_{n,c}`` are the vjp of the one-sample
    forward ``model_fn(params, x_n[None])[0]``.  The factor axis sits inside
    the per-sample vjp — ``vmap`` over samples of ``{vjp; vmap(vjp_fn) over
    the CF factor rows}`` — so the forward runs once per sample, not once per
    factor column (eager PyTorch does not share it the way XLA does); the
    result is then laid out ``[CF, S, …]``.  The batched forward that gives
    the factors runs once more, outside.

    ``model_fn`` must be per-sample separable (BatchNorm in eval mode).
    ``subsampling`` restricts the GGN to those samples (columns scaled by
    ``√(N/S)``; ``batch_size`` is the ``N``, default ``X.shape[0]``);
    ``column_scale`` overrides the scale; ``mc_samples``/``key`` select
    Monte-Carlo factors, drawn per global sample id (``sample_ids``, default
    the ``subsampling`` indices or ``0..N−1``); ``deflate_ce_null`` projects
    exact CE factor rows onto the null complement before the vjp
    (``CF − 1`` columns per sample; callers check
    :func:`vivit_tpu_torch.deflate.check_deflatable`).
    """
    check_subsampling_unique(subsampling)
    N = batch_size if batch_size is not None else X.shape[0]
    sample_ids = _sample_ids(X, subsampling, sample_ids)
    Xs, ys = _subsample(X, y, subsampling)
    params = {name: p.detach() for name, p in params.items()}

    with torch.no_grad():
        f = model_fn(params, Xs)
    factors = v_factors(loss, f, ys, batch_size=N, mc_samples=mc_samples, key=key,
                        sample_ids=sample_ids, column_scale=column_scale,
                        deflate_ce_null=deflate_ce_null)  # [S, CF', C]
    columns = pullback(model_fn, params, Xs, factors)  # {name: [S, CF', *shape]}
    return {name: c.transpose(0, 1).contiguous() for name, c in columns.items()}


def pullback(model_fn: ModelFn, params: Dict[str, torch.Tensor], Xs: torch.Tensor,
             rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The columns ``J_nᵀ s_{n,c}`` of given factor rows ``[S, CF, C]`` as
    ``{name: [S, CF, *shape]}``: ``vmap`` over samples of {one vjp of the
    one-sample forward; ``vmap(vjp_fn)`` over that sample's rows}."""
    from torch.func import vjp, vmap

    def sample_columns(x_n, rows_n):
        _, vjp_fn = vjp(lambda p: model_fn(p, x_n[None])[0], params)
        return vmap(vjp_fn)(rows_n)[0]  # {name: [CF, *shape]}

    return vmap(sample_columns)(Xs, rows)


def batch_grad(model, loss: Loss, X: torch.Tensor, y: torch.Tensor, *,
               params: Optional[Dict[str, torch.Tensor]] = None,
               subsampling: Optional[Sequence[int]] = None,
               batch_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Per-sample gradients ``ρ·∇ℓ_n`` as ``{parameter name: [S, *shape]}``.

    BackPACK's ``BatchGrad`` scaling, as in the JAX package: for mean
    reduction each gradient carries the ``1/N`` factor (``N = batch_size``,
    default ``X.shape[0]``).  ``model`` is an ``nn.Module`` or a model
    function with its ``params`` dict; ``torch.func.vmap`` of
    ``torch.func.grad`` over the one-sample forward, in full f32, so that
    cuDNN's convolutions do not fall to TF32.
    """
    from torch.func import grad, vmap

    from vivit_tpu_torch.engines import resolve_model
    from vivit_tpu_torch.precision import full_f32

    check_subsampling_unique(subsampling)
    model_fn, params = resolve_model(model, params)
    N = batch_size if batch_size is not None else X.shape[0]
    Xs, ys = _subsample(X, y, subsampling)
    rho = loss.rho(N)
    params = {name: p.detach() for name, p in params.items()}

    def sample_loss(p, x_n, y_n):
        f_n = model_fn(p, x_n[None])
        return rho * loss.per_sample(f_n, y_n[None])[0]

    with full_f32():
        return vmap(grad(sample_loss), in_dims=(None, 0, 0))(params, Xs, ys)


# Matrix-free curvature products (exact, not through V), in full f32 as the
# JAX package's are: cuDNN would otherwise run their convolutions in TF32.


def ggn_vector_product(model_fn: ModelFn, loss: Loss, params: Dict[str, torch.Tensor],
                       X: torch.Tensor, y: torch.Tensor,
                       v: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Exact GGN-vector product ``G v = Jᵀ (∂²L/∂f²) J v``: one jvp, the
    loss Hessian's product, one vjp (``torch.func``), in full f32.  ``v`` is
    a dict over the same names as ``params``."""
    from torch.func import jvp, vjp

    from vivit_tpu_torch.precision import full_f32

    params = {name: p.detach() for name, p in params.items()}
    v = {name: v[name] for name in params}
    with full_f32():
        f, jv = jvp(lambda p: model_fn(p, X), (params,), (v,))
        hjv = loss.hessian_vp(f, y, jv)
        _, vjp_fn = vjp(lambda p: model_fn(p, X), params)
        return vjp_fn(hjv)[0]


def hessian_vector_product(model_fn: ModelFn, loss: Loss, params: Dict[str, torch.Tensor],
                           X: torch.Tensor, y: torch.Tensor,
                           v: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Exact Hessian-vector product of the total loss, forward over reverse
    (jvp of grad), in full f32."""
    from torch.func import grad, jvp

    from vivit_tpu_torch.precision import full_f32

    params = {name: p.detach() for name, p in params.items()}
    v = {name: v[name] for name in params}
    with full_f32():
        return jvp(grad(lambda p: loss(model_fn(p, X), y)), (params,), (v,))[1]


def ggn_mat_prod(model_fn: ModelFn, loss: Loss, params: Dict[str, torch.Tensor],
                 X: torch.Tensor, y: torch.Tensor, mat: Dict[str, Any], *,
                 subsampling: Optional[Sequence[int]] = None) -> Dict[str, torch.Tensor]:
    """The exact GGN applied to stacked vectors ``{name: [K, *shape]}``;
    with ``subsampling`` the GGN of the sub-batch, with its own reduction
    weight.  Full f32, from :func:`ggn_vector_product`."""
    from torch.func import vmap

    Xs, ys = _subsample(X, y, subsampling)
    return vmap(lambda v: ggn_vector_product(model_fn, loss, params, Xs, ys, v))(mat)
