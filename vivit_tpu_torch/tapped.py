"""Tapped V-transform: one batched forward, one backward per factor column
(counterpart of ``vivit_tpu/tapped.py``).

1. **Taps.**  A forward hook on every ``nn.Linear`` and ``nn.Conv2d`` adds a
   zero tensor that requires grad (the tap) to the layer's output and
   records the layer's input ``z``.  The gradient of the model output w.r.t.
   the taps, seeded with one factor column ``s_{·,c}``, is the per-sample
   output cotangent ``δ_c [S, *out]`` of every layer at once: the taps carry
   the batch axis, so nothing is summed over samples.  The backward runs
   once per factor column (``CF'`` times, keeping the graph).
2. **Layer-local reconstruction** of each parameter's ``Vᵀ`` block from
   ``(z, δ)``:

   * Linear weight → :class:`~vivit_tpu_torch.structured.DenseFactor`
     ``(z, δ)``, never materialized; with extra input dimensions the
     Kronecker terms summed over them, materialized;
   * Linear bias → ``δ`` (summed over extra dimensions);
   * Conv weight → :class:`ConvVT`, one batched patch×cotangent product,
     patches from ``F.unfold`` in channel-major ``(I, kh, kw)`` order;
   * Conv bias → ``δ`` summed over output positions.

Every other parameter (other layer types, grouped or string-padded convs,
layers applied more than once) goes to the generic engine
(:func:`vivit_tpu_torch.ggn.ggn_sqrt_vt`) over those parameters alone: the
result is exact either way, the table is a fast path.

The steps are spans (:mod:`vivit_tpu_torch.utils.trace`):
``vtransform.forward`` (the tapped forward), ``vtransform.loss_hessian_sqrt``
(the loss factors), ``vtransform.backward`` (the ``CF'`` backwards) and
``vtransform.reconstruct`` (step 2 and the generic engine).
"""

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vivit_tpu_torch.ggn import _sample_ids, _subsample, ggn_sqrt_vt, v_factors
from vivit_tpu_torch.losses import Loss
from vivit_tpu_torch.utils import trace
from vivit_tpu_torch.utils.checks import check_subsampling_unique


class ConvVT:
    """Materialized conv-weight ``Vᵀ`` block in patch-native layout.

    ``vt``: ``[CF, S, I, kh, kw, O]``, the channel-major feature order of
    ``F.unfold``, kept as produced (f32, or demoted by ``conv_vt_dtype``).
    The parameter-facing methods permute only the small ``K``-stacked side
    into the PyTorch weight layout ``[O, I, kh, kw]`` (``kernel_shape``).
    """

    def __init__(self, vt: torch.Tensor, kernel_shape: Tuple[int, ...]):
        self.vt = vt
        self.kernel_shape = tuple(kernel_shape)

    @property
    def num_cols(self) -> int:
        cf, s = self.vt.shape[:2]
        return cf * s

    def _flat(self) -> torch.Tensor:
        return self.vt.reshape(self.num_cols, -1)

    def gram(self, precision=None) -> torch.Tensor:
        """``[CF·S, CF·S]`` Gram block; ``precision`` is the operand dtype
        (:func:`vivit_tpu_torch.precision.gram`)."""
        from vivit_tpu_torch.precision import gram

        return gram(self._flat(), precision)

    def _flat_as(self, other: torch.Tensor) -> torch.Tensor:
        """The flat block in the promoted dtype of itself and ``other``: a
        bf16-stored block is upcast exactly, as JAX promotes it."""
        return self._flat().to(torch.promote_types(self.vt.dtype, other.dtype))

    def v_mat_prod(self, gram_vecs: torch.Tensor) -> torch.Tensor:
        """``V @ ẽ`` for ``[K, CF·S]`` → ``[K, O, I, kh, kw]``."""
        k = gram_vecs.shape[0]
        flat = self._flat_as(gram_vecs)
        native = (gram_vecs.to(flat.dtype) @ flat).reshape(k, *self.vt.shape[2:])
        return native.permute(0, 4, 1, 2, 3)

    def vt_mat_prod(self, mat: torch.Tensor) -> torch.Tensor:
        """``Vᵀ @ m`` for ``[K, O, I, kh, kw]`` → ``[CF·S, K]``."""
        flat = self._flat_as(mat)
        native = mat.permute(0, 2, 3, 4, 1).reshape(mat.shape[0], -1)
        return flat @ native.to(flat.dtype).T


def _conv_supported(m: nn.Conv2d) -> bool:
    """Whether a Conv2d layer is inside the fast path (no groups, zero
    padding given as numbers)."""
    return (m.groups == 1 and m.padding_mode == "zeros"
            and not isinstance(m.padding, str))


def _fast_layers(module: nn.Module) -> Dict[str, nn.Module]:
    """The layers inside the fast-path table, by module name."""
    return {name: m for name, m in module.named_modules()
            if type(m) is nn.Linear or (type(m) is nn.Conv2d and _conv_supported(m))}


def tapped_ggn_sqrt_vt(
    module: nn.Module,
    loss: Loss,
    X: torch.Tensor,
    y: torch.Tensor,
    *,
    subsampling: Optional[Sequence[int]] = None,
    mc_samples: int = 0,
    key: Optional[int] = None,
    batch_size: Optional[int] = None,
    sample_ids=None,
    deflate_ce_null: bool = False,
    column_scale: Optional[float] = None,
    conv_vt_dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """Mixed ``Vᵀ`` dict ``{parameter name: tensor | DenseFactor | ConvVT}``.

    Tensor leaves carry leading ``[CF', S]`` axes.  ``subsampling`` restricts
    the GGN to those samples (columns rescaled by ``√(N/S)``); ``batch_size``
    is the ``N`` of the reduction weight (default ``X.shape[0]``);
    ``mc_samples``, ``key``, ``sample_ids`` and ``column_scale`` as in
    :func:`vivit_tpu_torch.ggn.ggn_sqrt_vt`, which also builds the blocks
    of the parameters outside the fast path.  ``conv_vt_dtype`` (e.g.
    ``torch.bfloat16``) stores the materialized conv-weight blocks demoted,
    cast after their f32 patch product: a bf16 Gram of them is then the same
    arithmetic as without the knob.
    """
    from vivit_tpu_torch.engines import forward_fn, module_params
    from vivit_tpu_torch.structured import DenseFactor

    check_subsampling_unique(subsampling)
    N = batch_size if batch_size is not None else X.shape[0]
    ids = _sample_ids(X, subsampling, sample_ids)
    Xs, ys = _subsample(X, y, subsampling)

    layers = _fast_layers(module)
    zs: Dict[str, torch.Tensor] = {}
    taps: Dict[str, torch.Tensor] = {}
    repeated = set()

    def hook_for(name):
        def hook(_, inputs, out):
            if name in taps:
                # weight sharing: the tap holds one call site's cotangent
                # only, so the layer goes to the generic engine
                repeated.add(name)
                return out
            zs[name] = inputs[0].detach()
            taps[name] = torch.zeros_like(out, requires_grad=True)
            return out + taps[name]
        return hook

    with trace.span("vtransform.forward", X):
        handles = [m.register_forward_hook(hook_for(name))
                   for name, m in layers.items()]
        try:
            with torch.enable_grad():
                f = module(Xs)
        finally:
            for h in handles:
                h.remove()

    with trace.span("vtransform.loss_hessian_sqrt", X):
        factors = v_factors(loss, f.detach(), ys, batch_size=N, mc_samples=mc_samples,
                            key=key, sample_ids=ids, column_scale=column_scale,
                            deflate_ce_null=deflate_ce_null)  # [S, CF', C]
    cots = factors.transpose(0, 1)  # [CF', S, C]
    names = list(taps)
    tap_list = [taps[n] for n in names]
    with trace.span("vtransform.backward", X):
        columns = [
            torch.autograd.grad(f, tap_list, grad_outputs=cot,
                                retain_graph=i + 1 < len(cots), allow_unused=True)
            for i, cot in enumerate(cots)
        ] if names else []
    with trace.span("vtransform.reconstruct", X):
        mixed: Dict[str, Any] = {}
        for j, name in enumerate(names):
            if name in repeated:
                continue
            m = layers[name]
            z = zs[name]
            d = torch.stack([col[j] if col[j] is not None else torch.zeros_like(tap_list[j])
                             for col in columns])  # [CF', S, *out]
            cf, s = d.shape[:2]
            prefix = f"{name}." if name else ""
            if type(m) is nn.Linear:
                if z.dim() == 2:
                    mixed[prefix + "weight"] = DenseFactor(z=z, delta=d)
                    if m.bias is not None:
                        mixed[prefix + "bias"] = d
                else:
                    # extra input dimensions: the Kronecker terms summed over them
                    zf = z.reshape(s, -1, z.shape[-1])
                    df = d.reshape(cf, s, -1, d.shape[-1])
                    mixed[prefix + "weight"] = torch.einsum("npi,cnpo->cnoi", zf, df)
                    if m.bias is not None:
                        mixed[prefix + "bias"] = df.sum(dim=2)
            else:
                patches = F.unfold(z, m.kernel_size, dilation=m.dilation,
                                   padding=m.padding, stride=m.stride)  # [S, K, L]
                df = d.reshape(cf, s, d.shape[2], -1)  # [CF', S, O, L]
                vt = torch.einsum("skl,csol->csko", patches, df)
                if conv_vt_dtype is not None:
                    vt = vt.to(conv_vt_dtype)
                o, i, kh, kw = m.weight.shape
                mixed[prefix + "weight"] = ConvVT(
                    vt.reshape(cf, s, i, kh, kw, o), m.weight.shape)
                if m.bias is not None:
                    mixed[prefix + "bias"] = df.sum(dim=-1)

        # the generic engine for every other parameter (exactness, not speed)
        params = module_params(module)
        leftover = {name: p for name, p in params.items() if name not in mixed}
        if leftover:
            model_fn = forward_fn(module)

            def model_fn_partial(diff, x):
                return model_fn({**params, **diff}, x)

            vt_generic = ggn_sqrt_vt(
                model_fn_partial, loss, leftover, X, y, subsampling=subsampling,
                mc_samples=mc_samples, key=key, batch_size=batch_size, sample_ids=ids,
                column_scale=column_scale, deflate_ce_null=deflate_ce_null)
            mixed.update(vt_generic)
        return {name: mixed[name] for name in params}
