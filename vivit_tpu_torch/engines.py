"""Engine dispatch: one V-transform entry for both model forms (counterpart
of ``vivit_tpu/engines.py``).

Every entry point takes the model as either

* an ``nn.Module`` → the structured engine
  (:func:`vivit_tpu_torch.structured.structured_ggn_sqrt_vt`:
  ``engine="tapped"`` by default, Kronecker-factored Linear blocks (2-D
  inputs, and token-shaped ones kept factored), patch-product Conv2d
  blocks, LayerNorm and batch-broadcast parameters from the taps, the
  generic engine for every other parameter), its parameters its own; or
* a plain ``model_fn(params, X)`` with a ``params`` dict ``{name: Tensor}``
  → the generic engine (:func:`vivit_tpu_torch.ggn.ggn_sqrt_vt`).

The ``*_any`` helpers make the Gram, back-projection and ``Vᵀg`` algebra
agnostic to which engine built the ``Vᵀ`` dict (mixed dicts carry
:class:`~vivit_tpu_torch.structured.DenseFactor` /
:class:`~vivit_tpu_torch.structured.TokenFactor` /
:class:`~vivit_tpu_torch.tapped.ConvVT` leaves, generic ones tensors).

Every entry point runs its call through :func:`stage` (or :func:`entry`):
the call's cache key (:func:`entry_key`) and the route rule that decides
whether it is captured as CUDA graphs (:func:`captured`) live here, the
capture itself in :mod:`vivit_tpu_torch.utils.graphs`.
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from vivit_tpu_torch.utils import graphs

# the share of the card's memory above which a call's ``Vᵀ`` at f32 (Gram
# side × parameters × 4 bytes) keeps it out of the graphs (:func:`captured`)
CAPTURE_SHARE = 0.25


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
    from vivit_tpu_torch.structured import DenseFactor, EmbeddingFactor, TokenFactor
    from vivit_tpu_torch.tapped import ConvVT

    return any(isinstance(leaf, (DenseFactor, TokenFactor, EmbeddingFactor, ConvVT))
               for leaf in vt.values())


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


def captured(X, mc_samples, solver, gram_side, numel) -> bool:
    """The route rule of the entry points: whether a call is captured.

    A call is captured when all of these hold:

    * its tensors are on CUDA (``X``; the parameters were checked to lie
      with it);
    * its loss factors are exact (``mc_samples == 0``): Monte-Carlo draws
      come from CPU generators (:func:`vivit_tpu_torch.losses.sample_generator`);
    * its ``Vᵀ`` at f32, ``4 · gram_side() · numel()`` bytes (``numel()``
      the parameters it covers), is at most :data:`CAPTURE_SHARE` of the
      card's memory.  A captured call's pool keeps its peak for as long as
      the entry lives, beside the memory the eager warm-up left in the
      allocator's cache, and the peak grows with the columns times the
      parameters; the launches that a capture saves do not grow with them,
      so at that size they are a small share of the call.  3c3d at N=128
      (a 1152-side Gram, 895,210 parameters: 4.1 GB) is captured; ViT-S/16
      at N=128 (1152, 21,669,514: 99.8 GB) runs eagerly, its chain solve
      captured alone (on an 80 GB H100 its whole call's capture runs out of
      memory after the warm-up; ``PERF.md``);
    * every Gram solve stays on ``eigh_dc``'s chain path or does not run
      it: ``solver`` other than ``"dc"`` (the vendor eigh, or LOBPCG as one
      eager step), or ``gram_side()``, the side of the Gram it solves
      (``(C−1)·S`` deflated, ``C·S`` not), below the strip threshold
      (:data:`vivit_tpu_torch.eigdc.STRIP_MIN`).

    Anything else runs eagerly, exactly as an uncaptured call does.  This
    is a route, not a fallback: a captured call whose capture fails
    raises.  :func:`stage` asks on each call of a key without an entry."""
    if not X.is_cuda or mc_samples:
        return False
    side = gram_side()
    if 4 * side * numel() > \
            CAPTURE_SHARE * torch.cuda.get_device_properties(X.device).total_memory:
        return False
    if solver != "dc":
        return True
    from vivit_tpu_torch.eigdc import STRIP_MIN

    return side < STRIP_MIN


def param_count(params) -> int:
    """The parameters (elements) of a ``{name: Tensor}`` dict."""
    return sum(p.numel() for p in params.values())


def gram_side(model_fn, params, X, subsampling, deflate) -> int:
    """The side of the Gram a call solves, ``(C−1)·S`` with ``deflate``,
    else ``C·S``: ``C`` from one forward of one sample, ``S`` the
    ``subsampling`` count or the batch."""
    with torch.no_grad():
        c = model_fn(params, X[:1]).shape[-1]
    return (c - bool(deflate)) * (X.shape[0] if subsampling is None else len(subsampling))


class _Ref:
    """An object in a key by identity.  The key holds it, so that its
    ``id`` cannot pass to another object while the key lives."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Ref) and other.obj is self.obj


def _part(value):
    """A setting as a hashable key part: sequences and dicts element by
    element; a callable by its ``graph_key`` attribute where it has one
    (:func:`~vivit_tpu_torch.optim.constant_damping` by its value), else by
    identity."""
    if isinstance(value, dict):
        return tuple((k, _part(v)) for k, v in value.items())
    if isinstance(value, (list, tuple, range)):
        return tuple(_part(v) for v in value)
    if callable(value) and not isinstance(value, type):
        return getattr(value, "graph_key", None) or _Ref(value)
    return value


def _spec(t):
    return tuple(t.shape), t.stride(), t.dtype, t.device


def entry_key(name, model, params, X, y, loss, route, **settings):
    """The cache key of one call of an entry point ``name``: ``(family,
    addresses)``.

    ``family`` holds the model by identity (:class:`_Ref`), each module's
    type and mode, every parameter (a module's buffers too, a model
    function's ``params``) by name with its shape, stride, dtype and device,
    ``X``'s and ``y``'s, the loss's type and reduction (a custom loss's
    function by identity), the cuDNN and TF32 flags, the route rule's
    inputs ``route`` and ``settings`` (see :func:`_part`).  ``addresses``
    are a module's tensors' ``data_ptr``s, ``()`` for a model function.

    A model function's ``params`` are static inputs, copied in before each
    replay as ``X`` and ``y`` are (:func:`stage`): a new dict of the same
    specs, as a functional update makes, replays.  A module's graphs read
    its tensors in place: an in-place update (an optimizer step,
    ``load_state_dict``) keeps the key, a replaced tensor changes the
    addresses and captures anew, dropping the family's stale entry."""
    if is_module(model):
        tensors = [*model.named_parameters(), *model.named_buffers()]
        structure = tuple((type(m), m.training) for m in model.modules())
        addresses = tuple(t.data_ptr() for _, t in tensors)
    else:
        tensors, structure, addresses = list(params.items()), (), ()
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    family = (name, _Ref(model), structure, tuple((n, *_spec(t)) for n, t in tensors),
              _spec(X), _spec(y), type(loss), loss.reduction,
              _part(getattr(loss, "_fn", None)), flags, _part(route),
              tuple((k, _part(v)) for k, v in sorted(settings.items())))
    return family, addresses


def stage(name, body, model, params, X, y, loss, mc_samples, solver, subsampling,
          deflate_ce_null, /, **settings):
    """``body(X, y, params)``, the program of one call of the entry point
    ``name``, through :func:`vivit_tpu_torch.utils.graphs.stage`:
    ``(outputs, replayed)``.  Replayed outputs are the entry's static ones,
    which the next replay overwrites (a computation class's eager rest reads
    them in place before its next call).

    ``params`` is a model function's dict or ``None`` (a module's tensors,
    read in place).  ``mc_samples``, ``solver`` (the Gram's eigensolver),
    ``subsampling`` (the Gram's sub-sample) and ``deflate_ce_null`` are the
    inputs of the route rule (:func:`captured`) and part of the key
    (:func:`entry_key`), with ``settings``, the rest of what shapes the
    call.  They are positional, so that ``settings`` may hold a setting of
    the same name (a computation class's own ``solver``)."""
    key = entry_key(name, model, params, X, y, loss,
                    (mc_samples, solver, subsampling, deflate_ce_null), **settings)

    def route():
        model_fn, fwd_params = resolve_model(model, params)
        return captured(
            X, mc_samples, solver,
            lambda: gram_side(model_fn, fwd_params, X, subsampling, deflate_ce_null),
            lambda: param_count(fwd_params))

    return graphs.stage(key, body, X, y, params, route)


def entry(*args, **settings):
    """:func:`stage`'s outputs, cloned where they came from the graphs."""
    out, replayed = stage(*args, **settings)
    return graphs.clone(out) if replayed else out
