"""Standalone Gram-matrix primitives (counterpart of
``vivit_tpu/extensions.py``): the reference's extension hooks
``CenteredBatchGrad``, ``GramBatchGrad``, ``CenteredGramBatchGrad``,
``GramSqrtGGNExact`` and ``GramSqrtGGNMC`` as functions of ``(model, X, y)``.

The model is an ``nn.Module`` or a model function with ``params=``
(:mod:`vivit_tpu_torch.engines`); ``layerwise`` dicts are keyed by
parameter name.  BackPACK's scaling is kept: per-sample gradients carry the
reduction factor ``ρ`` (``1/N`` for mean), so the Gram entries are
``⟨ρ gᵢ, ρ gⱼ⟩``.  Each entry runs in full f32 on ``device`` (default the
CUDA card; ``device="cpu"`` runs on the CPU).
"""

from typing import Dict, Optional, Tuple, Union

import torch

from vivit_tpu_torch.losses import Loss

Grams = Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _centered(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {name: g - g.mean(dim=0) for name, g in grads.items()}


def _summed(per_leaf: Dict[str, torch.Tensor], layerwise: bool) -> Grams:
    total = sum(per_leaf.values())
    return (total, per_leaf) if layerwise else total


def centered_batch_grad(model, loss: Loss, X, y, *,
                        params: Optional[Dict[str, torch.Tensor]] = None,
                        device=None) -> Dict[str, torch.Tensor]:
    """Per-sample gradients minus their batch mean, ``{name: [N, *shape]}``
    (reference ``CenteredBatchGrad``)."""
    from vivit_tpu_torch.ggn import batch_grad
    from vivit_tpu_torch.utils.device import inputs_on

    X, y = inputs_on(model, X, y, device, params=params)
    return _centered(batch_grad(model, loss, X, y, params=params))


def gram_batch_grad(model, loss: Loss, X, y, center: bool = False,
                    layerwise: bool = False, *,
                    params: Optional[Dict[str, torch.Tensor]] = None,
                    device=None) -> Grams:
    """``[N, N]`` Gram matrix of the (optionally centered) per-sample
    gradients (reference ``GramBatchGrad``/``CenteredGramBatchGrad``); with
    ``layerwise`` also the per-parameter Grams, ``(total, {name: [N, N]})``."""
    from vivit_tpu_torch.ggn import batch_grad
    from vivit_tpu_torch.gram import pairwise_dot
    from vivit_tpu_torch.precision import full_f32
    from vivit_tpu_torch.utils.device import inputs_on

    X, y = inputs_on(model, X, y, device, params=params)
    grads = batch_grad(model, loss, X, y, params=params)
    if center:
        grads = _centered(grads)
    with full_f32():
        return _summed({name: pairwise_dot(g, start_dim=1) for name, g in grads.items()},
                       layerwise)


def centered_gram_batch_grad(model, loss: Loss, X, y, layerwise: bool = False, *,
                             params: Optional[Dict[str, torch.Tensor]] = None,
                             device=None) -> Grams:
    """Centered variant of :func:`gram_batch_grad`."""
    return gram_batch_grad(model, loss, X, y, center=True, layerwise=layerwise,
                           params=params, device=device)


def gram_sqrt_ggn(model, loss: Loss, X, y, mc_samples: int = 0,
                  key: Optional[int] = None, layerwise: bool = False, *,
                  params: Optional[Dict[str, torch.Tensor]] = None,
                  device=None) -> Grams:
    """``[CF, N, CF, N]`` GGN Gram tensor summed over all parameters
    (reference ``GramSqrtGGNExact``/``GramSqrtGGNMC``; Monte-Carlo with
    ``mc_samples`` and the int ``key``), from the generic V-transform
    (:func:`vivit_tpu_torch.ggn.ggn_sqrt_vt`).  Flattened by
    :func:`vivit_tpu_torch.gram.reshape_as_square` it is the
    ``[CF·N, CF·N]`` matrix whose spectrum is the GGN's nonzero spectrum."""
    from vivit_tpu_torch.engines import resolve_model
    from vivit_tpu_torch.ggn import ggn_sqrt_vt
    from vivit_tpu_torch.gram import pairwise_dot
    from vivit_tpu_torch.precision import full_f32
    from vivit_tpu_torch.utils.device import inputs_on

    model_fn, fwd_params = resolve_model(model, params)
    X, y = inputs_on(model, X, y, device, params=params)
    with full_f32():
        vt = ggn_sqrt_vt(model_fn, loss, fwd_params, X, y, mc_samples=mc_samples, key=key)
        return _summed({name: pairwise_dot(leaf, start_dim=2) for name, leaf in vt.items()},
                       layerwise)
