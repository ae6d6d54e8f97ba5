"""Tapped V-transform: one batched forward, one backward per factor column
(counterpart of ``vivit_tpu/tapped.py``).

1. **Taps.**  A forward hook on every layer of the table below adds a zero
   that requires grad, broadcast to the output's shape without memory of
   its own (the tap), to the layer's output and records the layer's input
   ``z``.  The gradient of the model output w.r.t. the
   taps, seeded with one factor column ``s_{·,c}``, is the per-sample
   output cotangent ``δ_c [S, *out]`` of every layer at once: the taps carry
   the batch axis, so nothing is summed over samples.  The backward runs
   once per factor column (``CF'`` times, keeping the graph); a tap's
   columns are stacked when its block is built, and the list let go,
   written into one buffer as they come (a token-shaped Linear), or
   reduced at once where the block needs only their sums (LayerNorm).
2. **Layer-local reconstruction** of each parameter's ``Vᵀ`` block from
   ``(z, δ)``, the fast-path table:

   * Linear weight, 2-D input of one row a sample →
     :class:`~vivit_tpu_torch.structured.DenseFactor` ``(z, δ)``, never
     materialized;
   * Linear weight, input with extra (token) dimensions, or the batch
     flattened to rows (``[S·R, in]``, below) →
     :class:`~vivit_tpu_torch.structured.TokenFactor` ``(z, δ)`` over the
     flattened positions, never materialized (its Gram expands it in
     bounded chunks); :data:`~vivit_tpu_torch.structured.TOKEN_BLOCKS`
     counts them;
   * Linear weight fed rows gathered from the flattened batch (a mixture
     of experts' dispatch) → :class:`~vivit_tpu_torch.structured.RoutedFactor`,
     each sample's rows its positions (below);
     :data:`~vivit_tpu_torch.structured.ROUTED_BLOCKS` counts them and
     :data:`ROUTED_ROWS` their rows, once for the layers that share them;
   * Linear bias → ``δ`` (summed over extra dimensions, or over a sample's
     rows);
   * Conv weight → :class:`ConvVT`, one batched patch×cotangent product,
     patches from ``F.unfold`` in channel-major ``(I, kh, kw)`` order;
   * Conv bias → ``δ`` summed over output positions;
   * LayerNorm with an affine transform: weight ``Σ_p δ_p ∘ x̂_p``, bias
     ``Σ_p δ_p``, summed over the dimensions between the batch and the
     normalized ones; ``x̂`` is the normalized input, from the hooked input
     and the module's own ``eps``;
   * RMSNorm with a weight: ``Σ_p δ_p ∘ x̂_p``, ``x̂ = x / √(mean x² + eps)``
     over the normalized dimensions;
   * Embedding (no ``padding_idx``, ``max_norm`` or gradient scaling) →
     :class:`~vivit_tpu_torch.structured.EmbeddingFactor` ``(ids, δ)``,
     ``δ`` added into the rows of the sample's ids when its Gram
     materializes it;
   * a parameter broadcast over the batch (a class token, a learned
     position embedding): one of shape ``[1, ...]`` and rank 2 or more,
     held by a module outside the table.  The forward runs with a
     per-sample copy ``[S, ...]`` that requires grad in its place, and its
     gradient is the block, ``[CF', S, 1, ...]``.  The copy is exact only
     where the model broadcasts the leading axis over the batch, so every
     operation that takes the copy is checked: an addition, subtraction
     or product with a tensor of the same rank and leading size ``S``, an
     ``expand`` to leading size ``S``, or a ``cat`` of such tensors along
     another axis.  Any other use sends the parameter to the generic
     engine, and the forward runs again without its copy.

**Rows placed by sample.**  A 2-D Linear input is a ``DenseFactor`` only
where its rows are the samples.  The forward runs under a
``TorchFunctionMode`` that follows which sample each row of a 2-D tensor
comes from: a batch tensor ``[S, ..., d]`` flattened to ``[S·R, d]`` (row
``r`` of sample ``r // R``); its rows taken by a ``LongTensor`` or a mask
(``x[idx]``, ``index_select``) or sliced; and what keeps the rows
(``linear``, element-wise activations, element-wise products and sums of
tensors with the same rows or broadcast over them, casts and copies).  A
2-D Linear input it placed becomes a ``TokenFactor`` (the flattened batch
in its own order) or a ``RoutedFactor`` (rows gathered); the span
``vtransform.routing`` holds the gathering into segments.  An input whose
rows came through any other operation on placed rows, or that has another
leading size than the batch's, has rows it cannot place: its layer goes to
the generic engine.

Every other parameter (other layer types, grouped or string-padded convs,
layers applied more than once, Linear inputs whose rows are not placed)
goes to the generic engine
(:func:`vivit_tpu_torch.ggn.ggn_sqrt_vt`) over those parameters alone: the
result is exact either way, the table is a fast path.  :data:`GENERIC_PARAMS`
counts the parameters sent there.

The steps are spans (:mod:`vivit_tpu_torch.utils.trace`):
``vtransform.forward`` (the tapped forward), ``vtransform.loss_hessian_sqrt``
(the loss factors), ``vtransform.backward`` (the ``CF'`` backwards) and
``vtransform.reconstruct`` (step 2 and the generic engine; inside it
``vtransform.routing``).
"""

import weakref
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

from vivit_tpu_torch.ggn import _sample_ids, _subsample, ggn_sqrt_vt, v_factors
from vivit_tpu_torch.losses import Loss
from vivit_tpu_torch.utils import trace
from vivit_tpu_torch.utils.checks import check_subsampling_unique

# parameters (their elements) sent to the generic engine since the last
# reset (``GENERIC_PARAMS = 0``); a replay of captured CUDA graphs makes no
# Python call and adds nothing
GENERIC_PARAMS = 0
# rows of routed blocks placed by sample since the last reset
# (``ROUTED_ROWS = 0``), once for the layers that see the same rows
ROUTED_ROWS = 0

# the operations a broadcast parameter's per-sample copy may enter, by name:
# element-wise with a batch tensor, ``expand`` over the batch, ``cat``
_ELEMENTWISE = frozenset({
    "add", "add_", "__add__", "__radd__", "__iadd__", "sub", "sub_", "__sub__",
    "__rsub__", "__isub__", "mul", "mul_", "__mul__", "__rmul__", "__imul__"})
_CAT = frozenset({"cat", "concat", "concatenate"})
# the operations whose result keeps the rows of its 2-D operands (the row
# rule of the module docstring); ``linear`` keeps its input's
_ROWWISE = _ELEMENTWISE | frozenset({
    "div", "div_", "__truediv__", "__rtruediv__", "__itruediv__", "neg", "__neg__",
    "silu", "gelu", "relu", "relu_", "sigmoid", "tanh", "exp", "abs", "sqrt", "rsqrt",
    "square", "pow", "__pow__", "float", "double", "half", "bfloat16", "to", "type",
    "contiguous", "clone", "detach", "zeros_like", "ones_like", "empty_like",
    "requires_grad_", "dropout"})
_RESHAPE = frozenset({"view", "reshape", "flatten"})


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


_NORMS = (nn.LayerNorm, nn.RMSNorm)


def _embedding_supported(m: nn.Embedding) -> bool:
    """Whether an Embedding is inside the fast path (no padding row, no
    renormalization, no gradient scaling, dense gradients)."""
    return (m.padding_idx is None and m.max_norm is None and not m.scale_grad_by_freq
            and not m.sparse)


def _fast_layers(module: nn.Module) -> Dict[str, nn.Module]:
    """The layers inside the fast-path table, by module name."""
    return {name: m for name, m in module.named_modules()
            if type(m) is nn.Linear or (type(m) is nn.Conv2d and _conv_supported(m))
            or (type(m) in _NORMS and m.weight is not None)
            or (type(m) is nn.Embedding and _embedding_supported(m))}


def _normalized(x: torch.Tensor, m: nn.Module) -> torch.Tensor:
    """The normalized input over the normalized dimensions: LayerNorm's
    ``x̂ = (x − mean) / √(var + eps)``, RMSNorm's ``x / √(mean x² + eps)``
    (``eps`` None: the dtype's machine epsilon, as ``nn.RMSNorm``)."""
    dims = tuple(range(-len(m.normalized_shape), 0))
    if type(m) is nn.RMSNorm:
        eps = m.eps if m.eps is not None else torch.finfo(x.dtype).eps
        return x * torch.rsqrt(x.pow(2).mean(dim=dims, keepdim=True) + eps)
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + m.eps)


def _broadcast_candidates(params, layers) -> list:
    """The parameters of shape ``[1, ...]`` (rank 2 or more) held by a
    module outside the table."""
    owned = {f"{name}.{p}" if name else p for name, m in layers.items()
             for p, _ in m.named_parameters(recurse=False)}
    return [n for n, p in params.items()
            if n not in owned and p.dim() >= 2 and p.shape[0] == 1]


def _flat_args(args, kwargs):
    for a in (*args, *kwargs.values()):
        if isinstance(a, (list, tuple)):
            yield from a
        else:
            yield a


class _Misused(Exception):
    """A per-sample copy entered an operation outside the rule."""


class Rows:
    """The samples of a 2-D tensor's rows: ``sample [n]``, a LongTensor on
    the tensor's device; ``per`` ``R`` where the rows are the flattened
    batch ``[S·R, d]`` in its own order (row ``r`` of sample ``r // R``),
    else None (gathered)."""

    __slots__ = ("sample", "per")

    def __init__(self, sample, per=None):
        self.sample, self.per = sample, per


_FREE = object()  # a tensor the row rule has not seen


class _Watch(TorchFunctionMode):
    """Watches a tapped forward (module docstring).

    * The per-sample copies ``{name: [S, ...]}``: the first operation
      outside the broadcast rule records the copies it takes in ``bad`` and
      stops the forward (:class:`_Misused`) before it runs.
    * The rows of 2-D tensors (the row rule): :meth:`rows_of` gives the
      :class:`Rows` of a tensor that came from the flattened batch, None
      for one whose rows came through an operation outside the rule, and
      ``_FREE`` for any other.
    """

    def __init__(self, copies: Dict[str, torch.Tensor], s: int):
        super().__init__()
        self.copies, self.s, self.bad = copies, s, set()
        # by id: a weak reference to the tensor (an id outlives its tensor,
        # and a strong one would keep every intermediate alive) and its rows
        self.placed: Dict[int, Tuple[weakref.ref, Optional[Rows]]] = {}

    def _batch(self, t, ndim) -> bool:
        return isinstance(t, torch.Tensor) and t.dim() == ndim and t.shape[0] == self.s

    def _allowed(self, func, args, kwargs) -> bool:
        name = getattr(func, "__name__", "")
        if name in _ELEMENTWISE:
            pair = args[:2]
            return (len(pair) == 2 and isinstance(pair[0], torch.Tensor)
                    and all(self._batch(t, pair[0].dim()) for t in pair))
        if name == "expand":
            sizes = args[1] if len(args) == 2 and isinstance(args[1], (list, tuple)) \
                else args[1:]
            sizes = kwargs.get("size", sizes)
            return len(sizes) == args[0].dim() and sizes[0] == self.s
        if name in _CAT:
            seq = args[0] if args else kwargs.get("tensors", ())
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            ndim = seq[0].dim()
            return dim % ndim != 0 and all(self._batch(t, ndim) for t in seq)
        return False

    def rows_of(self, t):
        hit = self.placed.get(id(t))
        return hit[1] if hit is not None and hit[0]() is t else _FREE

    def _indexed(self, rows: Rows, index) -> Optional[Rows]:
        """The rows of ``x[index]`` (rows, slices or masks of them)."""
        if isinstance(index, tuple):
            rest = index[1:]
            if not index or not all(i is Ellipsis or (isinstance(i, slice) and i == slice(None))
                                    for i in rest):
                return None
            index = index[0]
        if isinstance(index, slice) or (
                isinstance(index, torch.Tensor) and index.dim() == 1
                and (index.dtype == torch.bool or not index.is_floating_point())):
            return Rows(rows.sample[index])
        return None

    def _rows(self, name, args, kwargs, out) -> Optional[Rows]:
        """The rows of ``out`` by the row rule, None where it does not hold."""
        x = args[0] if args else None
        known = self.rows_of(x) if isinstance(x, torch.Tensor) else _FREE
        if name in ("__getitem__", "index_select") and isinstance(known, Rows):
            if name == "__getitem__":
                return self._indexed(known, args[1])
            dim = args[1] if len(args) > 1 else kwargs.get("dim")
            return Rows(known.sample.index_select(0, args[2])) if dim == 0 else None
        if name in _RESHAPE or name == "linear":
            ok = isinstance(known, Rows) and out.shape[0] == x.shape[0]
            return known if ok and (name == "linear" or out.shape == x.shape) else None
        if name not in _ROWWISE:
            return None
        rows = None
        for t in _flat_args(args, kwargs):
            if not isinstance(t, torch.Tensor):
                continue
            r = self.rows_of(t)
            if r is _FREE and (t.dim() < out.dim() or t.shape[0] == 1 or t.stride(0) == 0):
                continue  # broadcast over the rows
            if not isinstance(r, Rows) or (rows is not None and r is not rows):
                return None
            rows = r
        return rows if rows is not None and out.shape[0] == rows.sample.numel() else None

    def _place(self, func, args, kwargs, out):
        name = getattr(func, "__name__", "")
        x = args[0] if args else None
        if (name in _RESHAPE and isinstance(x, torch.Tensor) and isinstance(out, torch.Tensor)
                and x.dim() >= 3 and x.shape[0] == self.s and out.dim() == 2
                and out.shape[1] == x.shape[-1] and self.rows_of(x) is _FREE):
            per = out.shape[0] // self.s
            sample = torch.arange(self.s, device=x.device).repeat_interleave(per)
            self.placed[id(out)] = (weakref.ref(out), Rows(sample, per))
            return
        if all(self.rows_of(t) is _FREE for t in _flat_args(args, kwargs)
               if isinstance(t, torch.Tensor)):
            return
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor) and o.dim() == 2:
                rows = self._rows(name, args, kwargs, o) if o is out else None
                self.placed[id(o)] = (weakref.ref(o), rows)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.copies:
            ids = {id(a) for a in _flat_args(args, kwargs)}
            hit = [n for n, c in self.copies.items() if id(c) in ids]
            if hit and not self._allowed(func, args, kwargs):
                self.bad.update(hit)
                raise _Misused
        out = func(*args, **kwargs)
        self._place(func, args, kwargs, out)
        return out


def _tapped_forward(module, Xs, layers, copies):
    """The forward with a tap on every table layer and ``copies`` in place
    of their parameters: ``(f, zs, taps, rows, repeated, bad)``; ``rows``
    maps each Linear with a 2-D input to its rows (:meth:`_Watch.rows_of`),
    ``bad`` names the copies used outside the rule (the forward is then to
    run again)."""
    zs: Dict[str, torch.Tensor] = {}
    taps: Dict[str, torch.Tensor] = {}
    rows: Dict[str, Any] = {}
    repeated = set()
    watch = _Watch(copies, Xs.shape[0])

    def hook_for(name, m):
        def hook(_, inputs, out):
            if name in taps:
                # weight sharing: the tap holds one call site's cotangent
                # only, so the layer goes to the generic engine
                repeated.add(name)
                return out
            x = inputs[0]
            if type(m) is nn.Linear and x.dim() == 2:
                rows[name] = watch.rows_of(x)
            zs[name] = x.detach()  # a norm's x̂ is formed after the backward
            zero = torch.zeros((), dtype=out.dtype, device=out.device, requires_grad=True)
            taps[name] = zero.expand(out.shape)
            return out + taps[name]
        return hook

    handles = [m.register_forward_hook(hook_for(name, m)) for name, m in layers.items()]
    f = None
    try:
        with torch.enable_grad(), watch:
            if copies:
                from torch.func import functional_call

                f = functional_call(module, copies, (Xs,), strict=False)
            else:
                f = module(Xs)
    except _Misused:
        pass
    finally:
        for h in handles:
            h.remove()
    return f, zs, taps, rows, repeated, watch.bad


def _linear_blocks(z, d, rows, s, segments):
    """``(weight block, bias block)`` of a Linear with input ``z`` and
    cotangents ``d [CF', n, ..., out]`` (module docstring's table), or None
    where the input's rows are not placed or its leading size is not the
    batch's: ``rows`` from :meth:`_Watch.rows_of` (``_FREE`` for an input
    with extra dimensions); ``segments`` caches the routed rows' segments
    by their :class:`Rows`."""
    global ROUTED_ROWS
    from vivit_tpu_torch import structured

    cf = d.shape[0]
    if rows is None or (rows is _FREE and z.shape[0] != s):
        return None
    if z.dim() == 2 and (rows is _FREE or rows.per == 1):
        return structured.DenseFactor(z=z, delta=d), d
    if rows is _FREE or rows.per is not None:
        # token dimensions, or the flattened batch: the positions kept factored
        zf = z.reshape(s, -1, z.shape[-1])
        df = d.reshape(cf, s, -1, d.shape[-1])
        structured.TOKEN_BLOCKS += 1
        return structured.TokenFactor(z=zf, delta=df), df.sum(dim=2)
    # rows gathered from the flattened batch: each sample's rows its segment
    with trace.span("vtransform.routing", z):
        if id(rows) not in segments:
            segments[id(rows)] = (rows, structured._segments(rows.sample, s))
            ROUTED_ROWS += rows.sample.numel()
        block = structured.routed_factor(z, d, rows.sample, s, segments[id(rows)][1])
        bias = d.new_zeros((cf, s, d.shape[-1])).index_add_(1, rows.sample, d)
    structured.ROUTED_BLOCKS += 1
    return block, bias


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
    """Mixed ``Vᵀ`` dict ``{parameter name: tensor | DenseFactor |
    TokenFactor | ConvVT}``.

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
    global GENERIC_PARAMS
    from vivit_tpu_torch import structured
    from vivit_tpu_torch.engines import forward_fn, module_params

    check_subsampling_unique(subsampling)
    N = batch_size if batch_size is not None else X.shape[0]
    ids = _sample_ids(X, subsampling, sample_ids)
    Xs, ys = _subsample(X, y, subsampling)
    s = Xs.shape[0]

    layers = _fast_layers(module)
    params = module_params(module)
    broadcast = _broadcast_candidates(params, layers)
    with trace.span("vtransform.forward", X):
        while True:
            copies = {n: params[n].expand(s, *params[n].shape[1:]).clone().requires_grad_()
                      for n in broadcast}
            f, zs, taps, rows, repeated, bad = _tapped_forward(module, Xs, layers, copies)
            if not bad:
                break
            broadcast = [n for n in broadcast if n not in bad]

    with trace.span("vtransform.loss_hessian_sqrt", X):
        factors = v_factors(loss, f.detach(), ys, batch_size=N, mc_samples=mc_samples,
                            key=key, sample_ids=ids, column_scale=column_scale,
                            deflate_ce_null=deflate_ce_null)  # [S, CF', C]
    cots = factors.transpose(0, 1)  # [CF', S, C]
    cf = cots.shape[0]
    names = [n for n in taps if n not in repeated]
    wrt = [taps[n] for n in names] + list(copies.values())
    keys = names + list(copies)
    norms = {n for n in names if type(layers[n]) in _NORMS}
    # a token or embedding block's columns go into one buffer as they come:
    # stacked later, their lists and the stack would be held at once, and
    # the allocator's cache fragments (ViT-S/16 at N=128 reserved 83.9 GB
    # so, 70.7 GB with the buffers); every other tap's columns are stacked
    tokens = {n for n in names if (type(layers[n]) is nn.Linear and zs[n].dim() > 2)
              or type(layers[n]) is nn.Embedding}
    columns: Dict[str, list] = {k: [] for k in keys}
    buffers: Dict[str, torch.Tensor] = {}
    with trace.span("vtransform.backward", X):
        for i, cot in enumerate(cots if wrt else ()):
            grads = torch.autograd.grad(f, wrt, grad_outputs=cot,
                                        retain_graph=i + 1 < cf, allow_unused=True)
            for k, ref, g in zip(keys, wrt, grads):
                if g is None:
                    g = torch.zeros_like(ref)
                if k in norms:
                    # a norm: the sums over the positions, at once
                    if i == 0:
                        zs[k] = _normalized(zs[k], layers[k])
                    w, b = g * zs[k], g
                    dims = tuple(range(1, g.dim() - len(layers[k].normalized_shape)))
                    if dims:
                        w, b = w.sum(dim=dims), b.sum(dim=dims)
                    g = (w, b)
                elif k in tokens:
                    if cf == 1:
                        buffers[k] = g.unsqueeze(0).contiguous()
                        continue
                    if k not in buffers:
                        buffers[k] = g.new_empty((cf, *g.shape))
                    buffers[k][i].copy_(g)
                    continue
                columns[k].append(g)
            del grads
    # the logits and their factors are let go before the blocks are built
    del f, factors, cots

    def stacked(k):
        """``[CF', S, ...]``: the columns of ``k`` stacked, then let go."""
        return torch.stack(columns.pop(k))

    with trace.span("vtransform.reconstruct", X):
        mixed: Dict[str, Any] = {}
        segments: Dict[int, Any] = {}  # the routed rows' segments, by their Rows
        for name in names:
            m = layers[name]
            prefix = f"{name}." if name else ""
            if name in norms:
                w, b = zip(*columns.pop(name))
                mixed[prefix + "weight"] = torch.stack(w)
                if getattr(m, "bias", None) is not None:
                    mixed[prefix + "bias"] = torch.stack(b)
                continue
            z = zs.pop(name)
            d = buffers.pop(name) if name in tokens else stacked(name)  # [CF', S, *out]
            if type(m) is nn.Embedding:
                mixed[prefix + "weight"] = structured.EmbeddingFactor(
                    z=z, delta=d, num_embeddings=m.num_embeddings)
            elif type(m) is nn.Linear:
                blocks = _linear_blocks(z, d, rows.get(name, _FREE), s, segments)
                if blocks is not None:  # else: rows not placed, the generic engine
                    mixed[prefix + "weight"], bias = blocks
                    if m.bias is not None:
                        mixed[prefix + "bias"] = bias
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
        for name in copies:
            mixed[name] = stacked(name).reshape(cf, s, *params[name].shape)

        # the generic engine for every other parameter (exactness, not speed)
        leftover = {name: p for name, p in params.items() if name not in mixed}
        if leftover:
            GENERIC_PARAMS += sum(p.numel() for p in leftover.values())
            model_fn = forward_fn(module)

            def model_fn_partial(diff, x):
                return model_fn({**params, **diff}, x)

            vt_generic = ggn_sqrt_vt(
                model_fn_partial, loss, leftover, X, y, subsampling=subsampling,
                mc_samples=mc_samples, key=key, batch_size=batch_size, sample_ids=ids,
                column_scale=column_scale, deflate_ce_null=deflate_ce_null)
            mixed.update(vt_generic)
        return {name: mixed[name] for name in params}
