"""Engine dispatch: one V-transform entry for both model forms (counterpart
of ``vivit_tpu/engines.py``).

Every entry point takes the model as either

* an ``nn.Module`` → the structured engine
  (:func:`vivit_tpu_torch.structured.structured_ggn_sqrt_vt`:
  ``engine="tapped"`` by default, Kronecker-factored Linear blocks,
  patch-product Conv2d blocks, the generic engine for every other
  parameter), its parameters its own; or
* a plain ``model_fn(params, X)`` with a ``params`` dict ``{name: Tensor}``
  → the generic engine (:func:`vivit_tpu_torch.ggn.ggn_sqrt_vt`).

The ``*_any`` helpers make the Gram, back-projection and ``Vᵀg`` algebra
agnostic to which engine built the ``Vᵀ`` dict (mixed dicts carry
:class:`~vivit_tpu_torch.structured.DenseFactor` /
:class:`~vivit_tpu_torch.tapped.ConvVT` leaves, generic ones tensors).
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn


def is_module(model) -> bool:
    """Whether the model is an ``nn.Module`` (structured-engine mode)."""
    return isinstance(model, nn.Module)


def forward_fn(module: nn.Module):
    """The ``model_fn(params, X)`` of a module: ``functional_call`` with the
    given parameters (buffers stay the module's)."""
    from torch.func import functional_call

    def model_fn(p, x):
        return functional_call(module, p, (x,))

    return model_fn


def module_params(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A module's parameters as a detached ``{name: Tensor}`` dict, in
    ``named_parameters`` order."""
    return {name: p.detach() for name, p in module.named_parameters()}


def resolve_model(model, params: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """``(model_fn, params)`` for either model form.

    A module gives :func:`forward_fn` and its own parameters (``params``
    must then be ``None``); a model function needs ``params``.
    """
    if is_module(model):
        if params is not None:
            raise ValueError(
                "an nn.Module brings its own parameters; pass params= only with "
                "a model function model_fn(params, X)."
            )
        return forward_fn(model), module_params(model)
    if not callable(model):
        raise TypeError(f"model must be an nn.Module or a callable, got {type(model).__name__}")
    if params is None:
        raise ValueError("a model function model_fn(params, X) needs params= (a {name: Tensor} dict).")
    return model, dict(params)


def build_vt(model, loss, params, X, y, *, engine: str = "tapped",
             conv_vt_dtype: Optional[torch.dtype] = None, **kwargs) -> Dict[str, Any]:
    """The ``Vᵀ`` dict by the engine of the model's form: a module →
    :func:`~vivit_tpu_torch.structured.structured_ggn_sqrt_vt` (mixed dict,
    ``engine`` and ``conv_vt_dtype`` honoured, ``params`` unused); a model
    function → :func:`~vivit_tpu_torch.ggn.ggn_sqrt_vt` (tensor dict,
    ``engine`` and ``conv_vt_dtype`` ignored: there is no module structure to
    find conv layers in).  ``kwargs``: ``subsampling``, ``mc_samples``,
    ``key``, ``batch_size``, ``sample_ids``, ``deflate_ce_null``."""
    if is_module(model):
        from vivit_tpu_torch.structured import structured_ggn_sqrt_vt

        return structured_ggn_sqrt_vt(model, loss, X, y, engine=engine,
                                      conv_vt_dtype=conv_vt_dtype, **kwargs)
    from vivit_tpu_torch.ggn import ggn_sqrt_vt

    return ggn_sqrt_vt(model, loss, params, X, y, **kwargs)


def vt_is_mixed(vt: Dict[str, Any]) -> bool:
    """Whether the ``Vᵀ`` dict carries factored (non-tensor) leaves."""
    from vivit_tpu_torch.structured import DenseFactor
    from vivit_tpu_torch.tapped import ConvVT

    return any(isinstance(leaf, (DenseFactor, ConvVT)) for leaf in vt.values())


def gram_any(vt, paths=None, precision=None) -> torch.Tensor:
    """Group Gram over either engine's ``Vᵀ`` dict; ``precision`` is the
    operand dtype of the materialized blocks."""
    if vt_is_mixed(vt):
        from vivit_tpu_torch.structured import gram_matrix_mixed

        return gram_matrix_mixed(vt, paths=paths, generic_precision=precision)
    from vivit_tpu_torch.gram import gram_matrix

    return gram_matrix(vt, paths=paths, precision=precision)


def v_mat_prod_any(vt, gram_vecs: torch.Tensor, paths: Sequence[str]) -> List[torch.Tensor]:
    """``V @ ẽ`` for stacked rows ``[K, CF·S]`` → leaves ``[K, *shape]``."""
    if vt_is_mixed(vt):
        from vivit_tpu_torch.structured import v_mat_prod_mixed

        return v_mat_prod_mixed(vt, gram_vecs, paths)
    from vivit_tpu_torch.gram import v_mat_prod

    return v_mat_prod(vt, gram_vecs, paths=paths)[1]


def vt_mat_prod_any(vt, mat_leaves: Sequence[torch.Tensor],
                    paths: Sequence[str]) -> torch.Tensor:
    """``Vᵀ @ m`` for leaves ``[K, *shape]`` → ``[CF·S, K]``."""
    if vt_is_mixed(vt):
        from vivit_tpu_torch.structured import vt_mat_prod_mixed

        return vt_mat_prod_mixed(vt, mat_leaves, paths)
    from vivit_tpu_torch.gram import vt_mat_prod

    return vt_mat_prod(vt, mat_leaves, paths=paths)


def backproject_any(vt, gram_evecs: torch.Tensor, paths: Sequence[str]) -> List[torch.Tensor]:
    """Normalized parameter-space eigenvectors from column-stacked Gram
    eigenvectors ``[CF·S, K]``: leaves ``[K, *param.shape]``."""
    from vivit_tpu_torch.gram import normalize

    return normalize(v_mat_prod_any(vt, gram_evecs.T, paths))
