"""Structure-exploiting GGN algebra (counterpart of
``vivit_tpu/structured.py``): the structured V-transform of an
``nn.Module`` (tapped or vjp engine), the mixed Gram, back-projection,
``Vᵀ``-products, the eigenvalue pipeline and the damped Newton step.

The factored leaves of a mixed ``Vᵀ`` dict, beside plain tensors
``[CF, S, *param.shape]`` and the conv blocks (:class:`~vivit_tpu_torch.tapped.ConvVT`):

* :class:`DenseFactor`, a Linear weight with a 2-D input: the ``Vᵀ`` column
  of sample ``n``, factor ``c`` is the outer product ``δ_{c,n} ⊗ z_n``, so
  its Gram block is the Hadamard product ``(Z Zᵀ) ∘ (Δ Δᵀ)``, in full f32
  and never materialized;
* :class:`TokenFactor`, a Linear weight whose input has extra (token)
  dimensions: the column is ``Σ_p δ_{c,n,p} ⊗ z_{n,p}`` over the ``T``
  positions, kept as ``(z, δ)``; its Gram block either expands the columns
  in bounded chunks or takes the ``T×T`` form, whichever costs fewer
  operations at the shapes it sees (:meth:`TokenFactor.gram`);
* :class:`RoutedFactor`, a Linear weight fed rows gathered from the
  flattened batch (a mixture of experts' dispatch): each sample's rows,
  however many, are its positions, padded with zero rows to the longest
  sample's (:func:`routed_factor`), a :class:`TokenFactor` otherwise;
* :class:`EmbeddingFactor`, an ``nn.Embedding`` table: the column is
  ``Σ_p e_{id_{n,p}} ⊗ δ_{c,n,p}``, kept as ``(ids, δ)`` and materialized
  a bounded chunk of table rows at a time for its Gram.

Gram matrices use the flat column index ``c·S + n`` (factor-major).  The
token blocks of one Gram are summed inside one span, ``gram.token_blocks``,
the routed blocks inside ``gram.routed_blocks`` and the embedding blocks
inside ``gram.embedding`` (:mod:`vivit_tpu_torch.utils.trace`);
:data:`TOKEN_BLOCKS` and :data:`ROUTED_BLOCKS` count the token and routed
blocks the tapped engine forms.
"""

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from vivit_tpu_torch.losses import Loss
from vivit_tpu_torch.utils import trace


@dataclass
class DenseFactor:
    """Kronecker-factored ``Vᵀ`` block of a Linear weight.

    ``z``: layer inputs ``[S, in]``; ``delta``: scaled output cotangents
    ``[CF, S, out]`` (they carry the column scale already).
    """

    z: torch.Tensor
    delta: torch.Tensor

    @property
    def num_cols(self) -> int:
        cf, s = self.delta.shape[:2]
        return cf * s

    def gram(self) -> torch.Tensor:
        """``[CF·S, CF·S]`` Gram block via the Hadamard factorization."""
        cf = self.delta.shape[0]
        zz = self.z @ self.z.T
        df = self.delta.reshape(self.num_cols, -1)
        return (df @ df.T) * zz.repeat(cf, cf)

    def v_mat_prod(self, gram_vecs: torch.Tensor) -> torch.Tensor:
        """``V @ ẽ`` for ``[K, CF·S]`` → ``[K, out, in]`` (weight layout)."""
        cf, s, _ = self.delta.shape
        gv = gram_vecs.reshape(gram_vecs.shape[0], cf, s)
        w = torch.einsum("kcn,cno->kno", gv, self.delta)
        return torch.einsum("kno,ni->koi", w, self.z)

    def vt_mat_prod(self, mat: torch.Tensor) -> torch.Tensor:
        """``Vᵀ @ m`` for ``[K, out, in]`` → ``[CF·S, K]``."""
        w = torch.einsum("ni,koi->kno", self.z, mat)
        r = torch.einsum("kno,cno->cnk", w, self.delta)
        return r.reshape(self.num_cols, r.shape[-1])


# the bytes of one f32 chunk of a token block's expansion (:meth:`TokenFactor.gram`)
TOKEN_CHUNK_BYTES = 1 << 30
# token blocks formed by the tapped engine since the last reset (``TOKEN_BLOCKS
# = 0``); a replay of captured CUDA graphs makes no Python call and adds nothing
TOKEN_BLOCKS = 0


@dataclass
class TokenFactor:
    """Factored ``Vᵀ`` block of a Linear weight whose input has extra
    (token) dimensions, flattened to ``T`` positions.

    ``z``: layer inputs ``[S, T, in]``; ``delta``: scaled output cotangents
    ``[CF, S, T, out]``.  Column ``(c, n)`` is ``Σ_p δ_{c,n,p} z_{n,p}ᵀ``,
    an ``[out, in]`` matrix in the weight's layout.

    The Gram block (:meth:`gram`) takes one of two forms, chosen from the
    shapes alone by their operation counts (``N = CF·S`` columns):

    * expansion, ``2·N·T·in·out`` to form the columns in f32 (chunks over
      ``out`` and ``in`` of at most :data:`TOKEN_CHUNK_BYTES`, each rounded
      to the Gram's operand dtype as a materialized block is) plus
      ``2·N²·in·out`` for their Gram, summed into one f32 Gram.  Off the
      CPU, f32 factors' chunks are formed by
      :func:`~vivit_tpu_torch.kernels.token_expand.token_expand_cuda`
      (three TF32 passes on the tensor cores, f32-faithful; launches
      counted in its module's ``LAUNCHES``), elsewhere by :meth:`expand`.  Each
      chunk's product runs in blocks of ``2^11`` of its columns, one
      batched product (``precision._BATCHED_K``;
      :func:`~vivit_tpu_torch.precision.gram_blocked`), each block's f32
      result added: an H100's
      bf16 GEMM with an f32 output sums a long contraction with an error
      that grows with its length (``PERF.md``: 2.6e-5 at 16,384, 4.9e-4 at
      196,608, 1.6e-3 at 589,824 against the exact sum);
    * the ``T×T`` form ``Σ_{p,q} (δ_{c,n,p}·δ_{c',m,q})(z_{n,p}·z_{m,q})``,
      ``2·(S·T)²·in + 2·(N·T)²·out + (N·T)²``, in full f32 like
      :class:`DenseFactor` (it holds ``(N·T)²`` values).

    The ``T×T`` form wins where ``T`` is small beside the widths; at
    ViT-S/16 (``T = 197``, ``in`` of 384 or 1536) it costs ``T²/in ≥ 25``
    times the expansion, which is taken.  The chunk's scratch is the f32
    chunk and its operand copy (:meth:`expand` adds ``CF`` copies of the
    ``z`` columns it reads).
    """

    z: torch.Tensor
    delta: torch.Tensor

    @property
    def num_cols(self) -> int:
        cf, s = self.delta.shape[:2]
        return cf * s

    def _flops(self):
        """``(expansion, T×T form)`` operation counts of the Gram block."""
        cf, s, t, o = self.delta.shape
        i, n = self.z.shape[-1], cf * s
        return (2 * n * t * i * o + 2 * n * n * i * o,
                2 * (s * t) ** 2 * i + 2 * (n * t) ** 2 * o + (n * t) ** 2)

    def _chunks(self):
        """``[(o0, o1, i0, i1)]``: the expansion's chunks, each at most
        :data:`TOKEN_CHUNK_BYTES` of f32 (one ``(o, i)`` pair at least),
        of near-equal sizes."""
        cf, s, _, o = self.delta.shape
        i = self.z.shape[-1]
        pairs = max(1, TOKEN_CHUNK_BYTES // (4 * cf * s))
        oc = min(o, pairs)
        ic = min(i, max(1, pairs // oc))
        oc = -(-o // -(-o // oc))
        ic = -(-i // -(-i // ic))
        return [(o0, min(o0 + oc, o), i0, min(i0 + ic, i))
                for o0 in range(0, o, oc) for i0 in range(0, i, ic)]

    def expand(self, o0=0, o1=None, i0=0, i1=None) -> torch.Tensor:
        """Columns ``[CF, S, o1-o0, i1-i0]`` of the rows ``o0:o1`` and
        columns ``i0:i1`` of the weight: one batched product over the
        ``CF·S`` columns, the ``T`` positions summed."""
        cf, s, t, o = self.delta.shape
        d = self.delta[..., o0:o1].reshape(cf * s, t, -1).mT  # [CF·S, oc, T]
        zc = self.z[..., i0:i1]
        zc = zc.unsqueeze(0).expand(cf, *zc.shape).reshape(cf * s, t, -1)
        return torch.bmm(d, zc).reshape(cf, s, d.shape[1], zc.shape[-1])

    def gram(self, precision=None, out=None) -> torch.Tensor:
        """``[CF·S, CF·S]`` Gram block, added into ``out`` when given;
        ``precision`` is the operand dtype of the expanded chunks
        (:func:`vivit_tpu_torch.precision.gram`)."""
        from vivit_tpu_torch.kernels.token_expand import token_expand_cuda
        from vivit_tpu_torch.precision import gram_blocked

        expand_flops, tt_flops = self._flops()
        if tt_flops < expand_flops:
            g = self._tt_gram()
            return g if out is None else out.add_(g)
        n = self.num_cols
        # the kernel's wrapper raises for a tensor it cannot take: no fallback
        on_card = (self.delta.device.type != "cpu"
                   and self.z.dtype == self.delta.dtype == torch.float32)
        for o0, o1, i0, i1 in self._chunks():
            if on_card:
                flat = token_expand_cuda(self.z, self.delta, o0, o1, i0, i1).reshape(n, -1)
            else:
                flat = self.expand(o0, o1, i0, i1).reshape(n, -1)
            if precision is not None:
                flat = flat.to(precision)
            out = gram_blocked(flat, precision, out)
        return out

    def _tt_gram(self) -> torch.Tensor:
        cf, s, t, o = self.delta.shape
        zf = self.z.reshape(s * t, -1)
        zz = (zf @ zf.T).reshape(1, s, t, 1, s, t)
        df = self.delta.reshape(cf * s * t, o)
        dd = (df @ df.T).reshape(cf, s, t, cf, s, t)
        return (dd * zz).sum(dim=(2, 5)).reshape(cf * s, cf * s)

    def v_mat_prod(self, gram_vecs: torch.Tensor) -> torch.Tensor:
        """``V @ ẽ`` for ``[K, CF·S]`` → ``[K, out, in]`` (weight layout)."""
        cf, s = self.delta.shape[:2]
        gv = gram_vecs.reshape(gram_vecs.shape[0], cf, s)
        w = torch.einsum("kcn,cnpo->knpo", gv, self.delta)
        return torch.einsum("knpo,npi->koi", w, self.z)

    def vt_mat_prod(self, mat: torch.Tensor) -> torch.Tensor:
        """``Vᵀ @ m`` for ``[K, out, in]`` → ``[CF·S, K]``."""
        w = torch.einsum("npi,koi->knpo", self.z, mat)
        r = torch.einsum("knpo,cnpo->cnk", w, self.delta)
        return r.reshape(self.num_cols, r.shape[-1])


# routed blocks formed by the tapped engine since the last reset
# (``ROUTED_BLOCKS = 0``)
ROUTED_BLOCKS = 0


class RoutedFactor(TokenFactor):
    """A :class:`TokenFactor` whose positions are the rows a sample routed
    to the layer, padded with zero rows (``z`` and ``δ`` zero) to the
    longest sample's count: a zero row adds nothing to a column, so the
    block is that of the ragged segments.  Built by :func:`routed_factor`."""


def _segments(sample: torch.Tensor, s: int):
    """``(order, slot, length)``: the rows sorted by sample (stable), each
    row's slot within its sample's segment, and the longest segment (at
    least 1; one host read)."""
    counts = torch.bincount(sample, minlength=s)
    order = torch.argsort(sample, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(sample.numel(), device=sample.device) - starts[sample[order]]
    return order, slot, max(1, int(counts.max())) if sample.numel() else 1


def routed_factor(z: torch.Tensor, delta: torch.Tensor, sample: torch.Tensor, s: int,
                  segments=None) -> RoutedFactor:
    """The block of a Linear weight whose input rows ``z [n, in]`` belong
    to the samples ``sample [n]`` (ids in ``0..s−1``), with cotangents
    ``δ [CF, n, out]``: each sample's rows gathered into its segment of
    ``[S, L, ·]``, ``L`` the longest.  ``segments`` (from
    :func:`_segments`) may be shared by the layers that see the same
    rows."""
    order, slot, length = segments or _segments(sample, s)
    owner = sample[order]
    zp = z.new_zeros((s, length, z.shape[-1]))
    zp[owner, slot] = z[order]
    dp = delta.new_zeros((delta.shape[0], s, length, delta.shape[-1]))
    dp[:, owner, slot] = delta[:, order]
    return RoutedFactor(z=zp, delta=dp)


@dataclass
class EmbeddingFactor:
    """Factored ``Vᵀ`` block of an ``nn.Embedding`` table of
    ``num_embeddings`` rows.

    ``z``: the token ids ``[S, T]``; ``delta``: scaled output cotangents
    ``[CF, S, T, dim]``.  Column ``(c, n)`` adds ``δ_{c,n,p}`` into row
    ``id_{n,p}`` of the table, for every position ``p``.  Its Gram
    (:meth:`gram`) materializes the columns over a chunk of table rows at a
    time (at most :data:`TOKEN_CHUNK_BYTES` of f32), rounded to the Gram's
    operand dtype, their products in K-blocks as a token block's.
    """

    z: torch.Tensor
    delta: torch.Tensor
    num_embeddings: int

    @property
    def num_cols(self) -> int:
        cf, s = self.delta.shape[:2]
        return cf * s

    def expand(self, r0=0, r1=None) -> torch.Tensor:
        """Columns ``[CF, S, r1-r0, dim]`` of the table rows ``r0:r1``."""
        cf, s, t, d = self.delta.shape
        r1 = self.num_embeddings if r1 is None else r1
        col = torch.arange(cf * s, device=self.z.device).view(cf, s, 1).expand(cf, s, t)
        row = self.z.unsqueeze(0).expand(cf, s, t)
        keep = (row >= r0) & (row < r1)
        out = self.delta.new_zeros((cf * s, r1 - r0, d))
        out.index_put_((col[keep], row[keep] - r0), self.delta[keep], accumulate=True)
        return out.reshape(cf, s, r1 - r0, d)

    def gram(self, precision=None, out=None) -> torch.Tensor:
        """``[CF·S, CF·S]`` Gram block, added into ``out`` when given."""
        from vivit_tpu_torch.precision import gram_blocked

        n, d = self.num_cols, self.delta.shape[-1]
        rows = max(1, TOKEN_CHUNK_BYTES // (4 * n * d))
        for r0 in range(0, self.num_embeddings, rows):
            flat = self.expand(r0, min(r0 + rows, self.num_embeddings)).reshape(n, -1)
            if precision is not None:
                flat = flat.to(precision)
            out = gram_blocked(flat, precision, out)
        return out

    def v_mat_prod(self, gram_vecs: torch.Tensor) -> torch.Tensor:
        """``V @ ẽ`` for ``[K, CF·S]`` → ``[K, num_embeddings, dim]``."""
        cf, s, t, d = self.delta.shape
        k = gram_vecs.shape[0]
        w = torch.einsum("kcn,cnpd->knpd", gram_vecs.reshape(k, cf, s), self.delta)
        out = w.new_zeros((k, self.num_embeddings, d))
        return out.index_add_(1, self.z.reshape(-1), w.reshape(k, s * t, d))

    def vt_mat_prod(self, mat: torch.Tensor) -> torch.Tensor:
        """``Vᵀ @ m`` for ``[K, num_embeddings, dim]`` → ``[CF·S, K]``."""
        rows = mat[:, self.z]  # [K, S, T, dim]
        r = torch.einsum("knpd,cnpd->cnk", rows, self.delta)
        return r.reshape(self.num_cols, r.shape[-1])


def _linear_inputs(module: nn.Module, X: torch.Tensor):
    """One forward recording each ``nn.Linear``'s input: ``({name: z},
    repeated)``, ``repeated`` the layers applied more than once (weight
    sharing), whose recorded input covers only the last call."""
    captured: Dict[str, torch.Tensor] = {}
    repeated = set()

    def hook_for(name):
        def hook(_, inputs, out):
            if name in captured:
                repeated.add(name)
            captured[name] = inputs[0].detach()
        return hook

    handles = [m.register_forward_hook(hook_for(name))
               for name, m in module.named_modules() if type(m) is nn.Linear]
    try:
        with torch.no_grad():
            module(X)
    finally:
        for h in handles:
            h.remove()
    return captured, repeated


def structured_ggn_sqrt_vt(
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
    engine: str = "tapped",
    conv_vt_dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """Mixed ``Vᵀ`` of a module: ``{name: tensor | DenseFactor | TokenFactor |
    ConvVT}``.

    ``engine="tapped"`` (default): :func:`vivit_tpu_torch.tapped.tapped_ggn_sqrt_vt`,
    its conv blocks stored in ``conv_vt_dtype`` when given (the vjp engine
    ignores the knob, as in the JAX package).
    ``engine="vjp"``: the generic engine (:func:`vivit_tpu_torch.ggn.ggn_sqrt_vt`)
    over every parameter but the weights of Linear layers with a 2-D input,
    a bias and one call site; those become :class:`DenseFactor` blocks of
    the recorded input and the generic bias cotangents (the bias cotangent
    of ``z Wᵀ + b`` is the output cotangent).  The other arguments as in
    :func:`~vivit_tpu_torch.ggn.ggn_sqrt_vt`.
    """
    if engine == "tapped":
        from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt

        return tapped_ggn_sqrt_vt(
            module, loss, X, y, subsampling=subsampling, mc_samples=mc_samples,
            key=key, batch_size=batch_size, sample_ids=sample_ids,
            deflate_ce_null=deflate_ce_null, conv_vt_dtype=conv_vt_dtype)
    if engine != "vjp":
        raise ValueError(f"Unknown engine {engine!r} (use 'tapped' or 'vjp').")
    from vivit_tpu_torch.engines import forward_fn, module_params
    from vivit_tpu_torch.ggn import _subsample, ggn_sqrt_vt
    from vivit_tpu_torch.utils.checks import check_subsampling_unique

    check_subsampling_unique(subsampling)
    inputs, repeated = _linear_inputs(module, _subsample(X, y, subsampling)[0])
    params = module_params(module)
    factorable = {}
    for name, z in inputs.items():
        prefix = f"{name}." if name else ""
        if name not in repeated and z.dim() == 2 and prefix + "bias" in params:
            factorable[prefix + "weight"] = (z, prefix + "bias")
    diff = {name: p for name, p in params.items() if name not in factorable}
    model_fn = forward_fn(module)

    def model_fn_partial(d, x):
        return model_fn({**params, **d}, x)

    vt = ggn_sqrt_vt(model_fn_partial, loss, diff, X, y, subsampling=subsampling,
                     mc_samples=mc_samples, key=key, batch_size=batch_size,
                     sample_ids=sample_ids, deflate_ce_null=deflate_ce_null)
    for weight, (z, bias) in factorable.items():
        vt[weight] = DenseFactor(z=z, delta=vt[bias])
    return {name: vt[name] for name in params}


def gram_matrix_mixed(
    vt_mixed: Dict[str, Any],
    paths: Optional[Sequence[str]] = None,
    generic_precision=None,
) -> torch.Tensor:
    """Gram over a mixed ``Vᵀ`` dict.

    ``generic_precision`` (an operand dtype from
    :data:`vivit_tpu_torch.precision._PRECISIONS`) applies to the
    materialized blocks (conv weights, biases) and to the expanded chunks
    of the token, routed and embedding blocks; the :class:`DenseFactor`
    blocks run in full f32.  The token blocks are summed first, into one
    Gram, inside one span ``gram.token_blocks``, then the routed blocks
    inside ``gram.routed_blocks`` and the embedding blocks inside
    ``gram.embedding``.
    """
    from vivit_tpu_torch.precision import gram
    from vivit_tpu_torch.tapped import ConvVT

    if paths is None:
        paths = list(vt_mixed.keys())
    total = None
    for kind, span in ((TokenFactor, "gram.token_blocks"),
                       (RoutedFactor, "gram.routed_blocks"),
                       (EmbeddingFactor, "gram.embedding")):
        leaves = [vt_mixed[p] for p in paths if type(vt_mixed[p]) is kind]
        if leaves:
            with trace.span(span, leaves[0].delta):
                for leaf in leaves:
                    total = leaf.gram(generic_precision, out=total)
    for p in paths:
        leaf = vt_mixed[p]
        if isinstance(leaf, (TokenFactor, EmbeddingFactor)):
            continue
        if isinstance(leaf, DenseFactor):
            g = leaf.gram()
        elif isinstance(leaf, ConvVT):
            g = leaf.gram(precision=generic_precision)
        else:
            cf, s = leaf.shape[:2]
            g = gram(leaf.reshape(cf * s, -1), generic_precision)
        total = g if total is None else total + g
    return total


def v_mat_prod_mixed(
    vt_mixed: Dict[str, Any],
    gram_vecs: torch.Tensor,
    paths: Sequence[str],
) -> List[torch.Tensor]:
    """Back-projection ``V @ ẽ`` over a mixed ``Vᵀ`` dict: stacked rows
    ``[K, CF·S]`` → one ``[K, *param.shape]`` tensor per path."""
    from vivit_tpu_torch.tapped import ConvVT

    k = gram_vecs.shape[0]
    gv = gram_vecs.reshape(k, -1)
    out = []
    for p in paths:
        leaf = vt_mixed[p]
        if isinstance(leaf, (DenseFactor, TokenFactor, EmbeddingFactor, ConvVT)):
            out.append(leaf.v_mat_prod(gv))
        else:
            cf, s = leaf.shape[:2]
            out.append((gv @ leaf.reshape(cf * s, -1)).reshape(k, *leaf.shape[2:]))
    return out


def vt_mat_prod_mixed(
    vt_mixed: Dict[str, Any],
    mat_leaves: Sequence[torch.Tensor],
    paths: Sequence[str],
) -> torch.Tensor:
    """``Vᵀ @ m`` over a mixed ``Vᵀ`` dict: ``mat_leaves[i]`` is
    ``[K, *param.shape]`` for ``paths[i]`` → ``[CF·S, K]``."""
    from vivit_tpu_torch.tapped import ConvVT

    total = None
    for p, m in zip(paths, mat_leaves):
        leaf = vt_mixed[p]
        if isinstance(leaf, (DenseFactor, TokenFactor, EmbeddingFactor, ConvVT)):
            r = leaf.vt_mat_prod(m)
        else:
            cf, s = leaf.shape[:2]
            r = leaf.reshape(cf * s, -1) @ m.reshape(m.shape[0], -1).T
        total = r if total is None else total + r
    return total


def newton_step_structured(
    module: nn.Module,
    loss: Loss,
    X,
    y,
    k: int,
    damping=1.0,
    *,
    subsampling_grad: Optional[Sequence[int]] = None,
    subsampling_ggn: Optional[Sequence[int]] = None,
    mc_samples_ggn: int = 0,
    key: Optional[int] = None,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    solver: str = "eigh",
    lobpcg_iters: int = 100,
    deflate_ce_null: bool = False,
    engine: str = "tapped",
    conv_vt_dtype: Optional[torch.dtype] = None,
    device=None,
) -> List[torch.Tensor]:
    """Damped Newton step along the top-``k`` GGN directions, one tensor
    per parameter in ``named_parameters`` order and layout.

    ``s = Σ_k −γ̄_k / (λ̄_k + δ_k) · e_k`` with the sample means of the
    directional derivatives (:func:`vivit_tpu_torch.optim.utils.gammas_lambdas`)
    and ``damping`` a scalar ``δ`` or a callable ``(evals, gram_evecs,
    gammas, lambdas) -> δ [k]``.  Steps: the undeflated ``Vᵀ`` (``engine``
    ``"tapped"`` or ``"vjp"``; Monte-Carlo factors with ``mc_samples_ggn``
    and the int ``key``; conv blocks stored in ``conv_vt_dtype``) over the
    ``subsampling_ggn`` samples, the mixed Gram (``gram_precision``), the top-``k`` (``solver`` ``"eigh"``,
    ``"dc"`` or ``"lobpcg"``; with ``deflate_ce_null`` on the Gram-level
    deflated Gram, lifted), per-sample gradients over ``subsampling_grad``,
    ``Vᵀ g``, γ/λ, and the back-projection of the Gram-space step.  ``X``
    is NHWC; ``device`` defaults to the CUDA card (``device="cpu"`` runs on
    the CPU).  This is :func:`vivit_tpu_torch.optim.newton_step_topk` over
    all parameters of the module.
    """
    from vivit_tpu_torch.optim.directional_damped_newton import newton_step_topk

    if loss.reduction != "mean":
        raise ValueError("Newton step requires reduction='mean'.")
    if not isinstance(module, nn.Module):
        raise TypeError("newton_step_structured takes an nn.Module; use "
                        "newton_step_topk(model_fn, ..., params=...) for a model function.")
    return newton_step_topk(
        module, loss, X, y, k, damping, subsampling_grad=subsampling_grad,
        subsampling_ggn=subsampling_ggn, mc_samples_ggn=mc_samples_ggn, key=key,
        precision=precision, gram_precision=gram_precision, solver=solver,
        lobpcg_iters=lobpcg_iters, deflate_ce_null=deflate_ce_null, engine=engine,
        conv_vt_dtype=conv_vt_dtype, device=device)


def eigvalsh_structured(
    module: nn.Module,
    loss: Loss,
    X,
    y,
    *,
    group_paths: Optional[Sequence[Sequence[str]]] = None,
    subsampling: Optional[Sequence[int]] = None,
    mc_samples: int = 0,
    key: Optional[int] = None,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    eig_backend: str = "xla",
    deflate_ce_null: bool = False,
    engine: str = "tapped",
    conv_vt_dtype: Optional[torch.dtype] = None,
    return_eig_info: bool = False,
    device=None,
):
    """GGN eigenvalues per parameter group, ascending.

    ``X`` is NHWC (the JAX layout), ``y`` integer targets; both move to
    ``device``, which defaults to the CUDA card (``device="cpu"`` runs on
    the CPU).  ``module``'s parameters must already lie on that device.

    ``gram_precision`` demotes only the materialized Gram contractions
    (``"bf16"``: bf16 operands, f32 result).  ``deflate_ce_null`` (exact
    cross-entropy) solves the ``(C−1)·S`` deflated Gram and returns the
    ``S`` structural zeros exactly.  ``eig_backend`` is ``"xla"`` (vendor
    eigensolver) or ``"dc"`` (:mod:`vivit_tpu_torch.eigdc`).
    ``mc_samples``/``key``: Monte-Carlo factors; ``engine``: ``"tapped"``
    or ``"vjp"`` (:func:`structured_ggn_sqrt_vt`); ``conv_vt_dtype``: the
    conv blocks' storage dtype (``torch.bfloat16`` beside the bf16 Gram
    gives the same Gram).  ``return_eig_info``:
    return ``(evals_per_group, infos_per_group)`` with the eigensolver's
    guard info.  On the card the call is captured
    (:func:`vivit_tpu_torch.engines.entry`): its first call per key captures
    it as CUDA graphs, later calls replay them.  The call's stages are spans
    (:mod:`vivit_tpu_torch.utils.trace`): ``eigvalsh_structured`` from the
    inputs on the device to the result, ``vtransform``, and per group
    ``gram`` and ``eigensolve``.
    """
    from vivit_tpu_torch.eig import full_eigh
    from vivit_tpu_torch.engines import entry
    from vivit_tpu_torch.precision import _PRECISIONS, matmul_precision
    from vivit_tpu_torch.utils.device import inputs_on

    if deflate_ce_null:
        from vivit_tpu_torch.deflate import check_deflatable

        check_deflatable(loss, mc_samples)
    X, y = inputs_on(module, X, y, device)
    if group_paths is None:
        group_paths = (tuple(n for n, _ in module.named_parameters()),)
    group_paths = tuple(tuple(paths) for paths in group_paths)
    s = X.shape[0] if subsampling is None else len(subsampling)

    def body(X, y, _params):
        with matmul_precision(precision):
            with trace.span("vtransform", X):
                vt = structured_ggn_sqrt_vt(module, loss, X, y, subsampling=subsampling,
                                            mc_samples=mc_samples, key=key,
                                            deflate_ce_null=deflate_ce_null, engine=engine,
                                            conv_vt_dtype=conv_vt_dtype)
            evals, infos = [], []
            for paths in group_paths:
                with trace.span("gram", X):
                    gram = gram_matrix_mixed(
                        vt, paths, generic_precision=_PRECISIONS[gram_precision])
                with trace.span("eigensolve", X):
                    ev, _, info = full_eigh(gram, backend=eig_backend,
                                            eigenvectors=False, return_info=True)
                if deflate_ce_null:
                    zeros = torch.zeros(s, dtype=ev.dtype, device=ev.device)
                    ev = torch.sort(torch.cat([zeros, ev])).values
                evals.append(ev)
                infos.append(info)
        if return_eig_info:
            return tuple(evals), tuple(infos)
        return tuple(evals)

    with trace.span("eigvalsh_structured", X):
        return entry("eigvalsh_structured", body, module, None, X, y, loss, mc_samples,
                     eig_backend, subsampling, deflate_ce_null, group_paths=group_paths,
                     precision=precision, gram_precision=gram_precision, engine=engine,
                     conv_vt_dtype=conv_vt_dtype, return_eig_info=return_eig_info)
