"""Data-parallel curvature over ``torch.distributed`` (counterpart of
``vivit_tpu/parallel/__init__.py``).

The mini-batch is sharded over the ranks of a process group, each rank
computes the ``Vᵀ`` columns of its shard, and the global ``NC×NC`` Gram is
assembled with collectives, resharding the *contraction* dimension instead
of gathering the big operand:

1. every rank holds ``V_local [cols_local, D]``,
2. ``all_to_all_single`` reshards it to ``[cols_global, D/k]``: each rank
   sends ``(k−1)/k`` of its ``V`` once,
3. one local matmul (:func:`vivit_tpu_torch.precision.dot_t`) forms a
   partial ``[cols_global, cols_global]`` Gram,
4. ``all_reduce`` sums the (small) partial Grams,
5. the eigendecomposition is replicated; per-sample results (γ, λ) stay
   with their rank; parameter-space vectors (eigenvectors, Newton steps)
   are ``all_reduce``-assembled.

The global Gram's column order is ``(rank, cf, local_sample)``, a
permutation of the single-device ``(cf, sample)`` order: eigenvalues are
permutation invariant, and every consumer here uses the same layout.

Conventions, JAX → port:

* JAX's ``mesh`` is ``group`` here, a ``torch.distributed`` process group
  in the same argument position; ``None`` is the default group.  There is
  no ``axis_name``: passing it raises ``TypeError``.
* A builder returns ``fn``, which **every rank** of the group calls with
  its own shard ``X_l, y_l`` (the body that ``shard_map`` traces in JAX).
  Shards have equal sizes (one ``all_gather`` of ``n_local`` per call
  checks it); rank ``r`` holds the global samples
  ``r·n_local + arange(n_local)``, the ids that ``subsampling`` indexes and
  that Monte-Carlo draws are a function of (with the int ``key``), so a
  draw does not depend on the layout.
* The group must be initialized (``torch.distributed.init_process_group``,
  or :func:`vivit_tpu_torch.parallel.launch.spawn`); there is no
  single-process path.
* The rank's device is ``device``, the CUDA card unless ``device="cpu"``
  (:func:`vivit_tpu_torch.utils.device.resolve_device`).  CUDA tensors need
  an NCCL group and CPU tensors a gloo group; any other pairing raises.
* The model-function builders' ``fn`` takes ``(params, X_l, y_l, key)``,
  ``params`` a ``{name: Tensor}`` dict on the device; the structured ones
  take an ``nn.Module`` whose parameters lie there, and ``fn(X_l, y_l,
  key)``.
"""

from collections import namedtuple
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from vivit_tpu_torch.deflate import check_deflatable
from vivit_tpu_torch.eig import full_eigh, topk_eigh
from vivit_tpu_torch.ggn import batch_grad, ggn_sqrt_vt
from vivit_tpu_torch.linalg.utils import kept_indices, warn_if_small
from vivit_tpu_torch.losses import Loss
from vivit_tpu_torch.precision import _PRECISIONS, dot_t, matmul_precision
from vivit_tpu_torch.utils.checks import check_subsampling_unique
from vivit_tpu_torch.utils.device import (
    as_batch,
    check_module_on,
    check_params_on,
    resolve_device,
)
from vivit_tpu_torch.utils.tree import select_paths, unravel_like


def _world(group):
    """``(rank, world size)`` in ``group``; raises unless a process group is
    initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "vivit_tpu_torch.parallel needs an initialized process group: call "
            "torch.distributed.init_process_group(...) in every rank first "
            "(vivit_tpu_torch.parallel.launch.spawn does)."
        )
    return dist.get_rank(group), dist.get_world_size(group)


def _rank_device(group, device) -> torch.device:
    """The rank's device (:func:`resolve_device`), checked against the
    group's backend: NCCL carries CUDA tensors, gloo CPU tensors."""
    device = resolve_device(device)
    _world(group)
    backend = str(dist.get_backend(group)).lower()
    need = "nccl" if device.type == "cuda" else "gloo"
    if need not in backend:
        raise ValueError(
            f"a rank on {device.type} needs a {need} process group, got backend "
            f"{backend!r} (NCCL carries CUDA tensors, gloo CPU tensors)"
        )
    return device


def _all_gather(t: torch.Tensor, group, k: int) -> torch.Tensor:
    """``[k, *t.shape]``: every rank's ``t`` in rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(k)]
    dist.all_gather(out, t, group=group)
    return torch.stack(out)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group (in place on a fresh contiguous
    tensor, which is returned)."""
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def _reshard_cols(v_local: torch.Tensor, group, k: int) -> torch.Tensor:
    """``[cols_local, D] → [k·cols_local, ⌈D/k⌉]``: split ``D`` over the
    ranks, gather the columns in rank order.

    JAX's tiled ``all_to_all(split_axis=1, concat_axis=0)``;
    ``all_to_all_single`` splits dim 0, so block ``j`` of ``D`` is laid out
    first (``[k, cols, D/k]``, contiguous) and goes to rank ``j``; what
    arrives is rank ``i``'s rows in block ``i``.
    """
    cols, d = v_local.shape
    pad = (-d) % k
    if pad:
        v_local = F.pad(v_local, (0, pad))
    send = v_local.reshape(cols, k, -1).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.reshape(k * cols, -1)


_Shard = namedtuple("_Shard", "rank k n_local n_global ids X y")


def _shard(group, device, X_l, y_l) -> _Shard:
    """This rank's call: ``X_l``, ``y_l`` on ``device`` (f32 inputs), the
    equal-size check over the group, the global sample ids."""
    rank, k = _world(group)
    X_l, y_l = as_batch(X_l, y_l, device)
    n_local = X_l.shape[0]
    sizes = _all_gather(torch.tensor([n_local], device=device), group, k).reshape(-1).tolist()
    if len(set(sizes)) != 1:
        raise ValueError(f"unequal shards: the ranks hold {sizes} samples; "
                         "every rank needs the same number")
    ids = list(range(rank * n_local, (rank + 1) * n_local))
    return _Shard(rank, k, n_local, n_local * k, ids, X_l, y_l)


def _sample_mask(ids, subsampling, device) -> torch.Tensor:
    """``[n_local]`` f32: 1 where the global id is selected."""
    return torch.isin(torch.as_tensor(ids, device=device),
                      torch.as_tensor(list(subsampling), device=device)).float()


def _flatten_vt(vt, paths: Optional[Sequence[str]] = None) -> torch.Tensor:
    """``Vᵀ`` dict → ``[CF·S, D]`` (cf-major rows); ``paths`` restricts and
    orders the leaves (block-diagonal groups)."""
    items = vt.items() if paths is None else select_paths(vt, paths)
    return torch.cat([leaf.reshape(leaf.shape[0] * leaf.shape[1], -1)
                      for _, leaf in items], dim=1)


def _dp_column_scale(loss, n_global, subsampling, ids, device):
    """Column scale and selection mask of a (sub-sampled) shard.

    Shards keep their shapes: every local column is computed and the
    non-selected ones are *zeroed*, so the Gram carries ``(N − |S|)·CF``
    extra zero rows and columns; the nonzero spectrum is the single-device
    sub-sampled estimate ``(N/|S|)·ρ·Σ_{n∈S} J_nᵀ H_n J_n``.
    """
    if subsampling is None:
        return loss.rho(n_global) ** 0.5, None
    scale = (loss.rho(n_global) * n_global / len(subsampling)) ** 0.5
    return scale, _sample_mask(ids, subsampling, device)


def _per_sample(scale, ndim: int):
    """A scalar, or an ``[S]`` vector shaped to broadcast at the sample axis
    of a ``[CF, S, ...]`` leaf of ``ndim`` dimensions."""
    if isinstance(scale, torch.Tensor) and scale.dim() == 1:
        return scale.reshape(1, -1, *(1,) * (ndim - 2))
    return scale


def _mask_vt(vt, mask):
    """Zero the ``Vᵀ`` columns of non-selected samples."""
    return {p: leaf * _per_sample(mask, leaf.dim()) for p, leaf in vt.items()}


def _scale_cols_mixed(vt, scale):
    """Scale the columns of a *mixed* ``Vᵀ`` dict by a scalar or a
    per-sample ``[S]`` vector: a :class:`DenseFactor` on ``δ`` (``z`` is
    shared across columns), a :class:`ConvVT` block in f32 and cast back to
    its dtype, a tensor leaf over its trailing axes."""
    from vivit_tpu_torch.structured import DenseFactor
    from vivit_tpu_torch.tapped import ConvVT

    out = {}
    for p, leaf in vt.items():
        if isinstance(leaf, DenseFactor):
            out[p] = DenseFactor(z=leaf.z, delta=leaf.delta * _per_sample(scale, leaf.delta.dim()))
        elif isinstance(leaf, ConvVT):
            f = _per_sample(scale, leaf.vt.dim())
            out[p] = ConvVT((leaf.vt.float() * f).to(leaf.vt.dtype), leaf.kernel_shape)
        else:
            out[p] = leaf * _per_sample(scale, leaf.dim())
    return out


def _num_cols_mixed(leaf) -> int:
    """Column count ``CF·S`` of one mixed-dict leaf."""
    return leaf.num_cols if hasattr(leaf, "num_cols") else leaf.shape[0] * leaf.shape[1]


def sharded_gram(v_local: torch.Tensor, group=None, precision=None) -> torch.Tensor:
    """Global Gram of rank-sharded ``V`` rows; every rank of ``group`` calls
    it with its own ``v_local [cols_local, D]``.

    ``D`` is padded to a multiple of the world size ``k``, resharded
    (``all_to_all_single``), contracted locally (``precision``: the operand
    dtype of :func:`vivit_tpu_torch.precision.dot_t`, ``None`` full f32 in
    blocks of the contraction) and summed (``all_reduce``).  Returns the
    replicated ``[k·cols_local, k·cols_local]`` f32 Gram, column order
    ``(rank, local_col)``.
    """
    _, k = _world(group)
    v = _reshard_cols(v_local, group, k)
    return _all_reduce(dot_t(v, v, precision), group)


def _solve_spectrum(gram, eig_backend: str, zeros: int):
    """``(ascending eigenvalues, guard info)`` of a Gram; ``zeros`` exact
    structural zeros joined (factor-level CE deflation)."""
    evals, _, info = full_eigh(gram, backend=eig_backend, eigenvectors=False,
                               return_info=True)
    if zeros:
        evals = torch.sort(torch.cat([evals.new_zeros(zeros), evals])).values
    return evals, info


def _spectra_result(solved, grouped: bool, return_eig_info: bool):
    """The eigenvalue builders' result: one ``(evals, info)`` per group →
    ``evals`` (or a tuple of them under ``group_paths``), with the infos
    when asked."""
    evs = tuple(ev for ev, _ in solved)
    infos = tuple(info for _, info in solved)
    if not grouped:
        return (evs[0], infos[0]) if return_eig_info else evs[0]
    return (evs, infos) if return_eig_info else evs


def eigvalsh_dp(
    model_fn,
    loss: Loss,
    group,
    *,
    mc_samples: int = 0,
    precision: str = "highest",
    group_paths: Optional[Sequence[Sequence[str]]] = None,
    subsampling: Optional[Sequence[int]] = None,
    eig_backend: str = "xla",
    deflate_ce_null: bool = False,
    return_eig_info: bool = False,
    device=None,
) -> Callable:
    """Build a data-parallel GGN eigenvalue function.

    Returns ``fn(params, X_l, y_l, key=None) -> evals``, run by every rank on
    its shard; the eigenvalues (replicated) are those of the single-device
    :func:`vivit_tpu_torch.linalg.eigvalsh` on the global batch.

    ``group_paths``: block-diagonal groups of parameter names; the result
    becomes a tuple of eigenvalue vectors, one per group.  ``subsampling``
    takes *global* sample indices; non-selected columns are zeroed, so the
    spectrum carries ``(N−|S|)·CF`` extra exact zeros (they are the dc
    solver's weak regime: prefer ``eig_backend="xla"``, the port's name for
    ``torch.linalg.eigh``, there).  ``eig_backend="dc"``: the spectral
    divide-and-conquer solver (:mod:`vivit_tpu_torch.eigdc`), deterministic,
    so every rank computes the same values.  ``deflate_ce_null`` (exact CE):
    each shard projects its factor rows onto the CE null complement before
    the backward, so the Gram and its collectives shrink to ``(C−1)·N``;
    the ``N`` structural zeros are joined exactly.  ``return_eig_info``:
    ``fn`` also returns the guard info ``{"tripped", "bound", "orth"}`` (one
    per group under ``group_paths``).
    """
    check_subsampling_unique(subsampling)
    if deflate_ce_null:
        check_deflatable(loss, mc_samples)
    device = _rank_device(group, device)

    def fn(params, X_l, y_l, key=None):
        check_params_on(params, device, "move the params dict to the rank's device first.")
        sh = _shard(group, device, X_l, y_l)
        zeros = sh.n_global if deflate_ce_null else 0
        with matmul_precision(precision):
            scale, mask = _dp_column_scale(loss, sh.n_global, subsampling, sh.ids, device)
            vt = ggn_sqrt_vt(model_fn, loss, params, sh.X, sh.y, mc_samples=mc_samples,
                             key=key, column_scale=scale, sample_ids=sh.ids,
                             deflate_ce_null=deflate_ce_null)
            if mask is not None:
                # masking commutes with the per-sample factor projection
                vt = _mask_vt(vt, mask)
            groups = [None] if group_paths is None else [tuple(p) for p in group_paths]
            solved = [_solve_spectrum(sharded_gram(_flatten_vt(vt, paths), group),
                                      eig_backend, zeros) for paths in groups]
        return _spectra_result(solved, group_paths is not None, return_eig_info)

    return fn


def _structured_gram_dp(vt, rescale, group, generic_precision, paths=None):
    """Global Gram of a mixed (factored + generic) shard ``Vᵀ``.

    Dense ``(z, δ)`` factors are small: one ``all_gather`` each, ``δ``
    rescaled, the block ``(ZZᵀ)∘(ΔΔᵀ)`` formed in full f32 on every rank;
    generic leaves and the materialized conv blocks (:class:`ConvVT`, big)
    go through :func:`sharded_gram` with the operand dtype
    ``generic_precision``.  Column order ``(rank, cf, n_local)`` on both
    parts; ``paths`` restricts the leaves (block-diagonal groups).
    """
    from vivit_tpu_torch.structured import DenseFactor
    from vivit_tpu_torch.tapped import ConvVT

    _, k = _world(group)
    gram, generic = None, []
    items = vt.items() if paths is None else select_paths(vt, paths)
    for _, leaf in items:
        if isinstance(leaf, DenseFactor):
            z_g = _all_gather(leaf.z, group, k)  # [k, S_l, in]
            d_g = _all_gather(leaf.delta * rescale, group, k)  # [k, CF, S_l, out]
            kk, cf, s_l, _ = d_g.shape
            zz = torch.einsum("ani,bmi->anbm", z_g, z_g)  # [k, S_l, k, S_l]
            df = d_g.reshape(kk * cf * s_l, -1)
            dd = (df @ df.T).reshape(kk, cf, s_l, kk, cf, s_l)
            g = (dd * zz[:, None, :, :, None, :]).reshape(kk * cf * s_l, -1)
            gram = g if gram is None else gram + g
        elif isinstance(leaf, ConvVT):
            generic.append(leaf._flat() * rescale)
        else:
            generic.append(leaf.reshape(leaf.shape[0] * leaf.shape[1], -1) * rescale)
    if generic:
        g = sharded_gram(torch.cat(generic, dim=1), group, precision=generic_precision)
        gram = g if gram is None else gram + g
    return gram


def eigvalsh_dp_structured(
    module,
    loss: Loss,
    group,
    *,
    mc_samples: int = 0,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    group_paths: Optional[Sequence[Sequence[str]]] = None,
    subsampling: Optional[Sequence[int]] = None,
    eig_backend: str = "xla",
    deflate_ce_null: bool = False,
    return_eig_info: bool = False,
    engine: str = "tapped",
    conv_vt_dtype: Optional[torch.dtype] = None,
    device=None,
) -> Callable:
    """Data-parallel eigenvalues with the structured V-transform of an
    ``nn.Module`` (:func:`vivit_tpu_torch.structured.structured_ggn_sqrt_vt`,
    ``engine`` ``"tapped"`` or ``"vjp"``; ``conv_vt_dtype`` stores the conv
    blocks demoted before the collectives).

    Returns ``fn(X_l, y_l, key=None) -> evals``, the module's parameters
    its own.  The Gram comes from :func:`_structured_gram_dp`: Dense factors
    through ``all_gather``, conv and generic blocks through
    :func:`sharded_gram` (``gram_precision``: ``"bf16"`` demotes their
    operands).  The V-transform scales each shard's columns locally by
    ``√ρ(n_local)``; they are rescaled by ``√(ρ(N)/ρ(n_local))`` (and
    ``√(N/|S|)`` under ``subsampling``).  ``group_paths``, ``subsampling``
    (global indices, zero-masked columns), ``mc_samples``, ``eig_backend``,
    ``deflate_ce_null`` and ``return_eig_info`` as in :func:`eigvalsh_dp`.
    """
    check_subsampling_unique(subsampling)
    if deflate_ce_null:
        check_deflatable(loss, mc_samples)
    gp = _PRECISIONS[gram_precision]
    device = _rank_device(group, device)

    def fn(X_l, y_l, key=None):
        from vivit_tpu_torch.structured import structured_ggn_sqrt_vt

        check_module_on(module, device)
        sh = _shard(group, device, X_l, y_l)
        zeros = sh.n_global if deflate_ce_null else 0
        with matmul_precision(precision):
            vt = structured_ggn_sqrt_vt(module, loss, sh.X, sh.y, mc_samples=mc_samples,
                                        key=key, sample_ids=sh.ids,
                                        deflate_ce_null=deflate_ce_null, engine=engine,
                                        conv_vt_dtype=conv_vt_dtype)
            rescale = (loss.rho(sh.n_global) / loss.rho(sh.n_local)) ** 0.5
            if subsampling is not None:
                rescale *= (sh.n_global / len(subsampling)) ** 0.5
                vt = _scale_cols_mixed(vt, _sample_mask(sh.ids, subsampling, device))
            groups = [None] if group_paths is None else [tuple(p) for p in group_paths]
            solved = [_solve_spectrum(_structured_gram_dp(vt, rescale, group, gp, paths),
                                      eig_backend, zeros) for paths in groups]
        return _spectra_result(solved, group_paths is not None, return_eig_info)

    return fn


def _rows_of_rank(evecs: torch.Tensor, rank: int, cols_local: int) -> torch.Tensor:
    """This rank's rows of replicated Gram-space vectors ``[cols, K]``."""
    return evecs[rank * cols_local:(rank + 1) * cols_local]


def _stack_evecs(e_par: Optional[torch.Tensor], params, count: int):
    """Columns of ``e_par [D, K]`` as ``{name: [K, *shape]}`` over
    ``params``' names and shapes (empty leaves when ``count == 0``)."""
    out, off = {}, 0
    for name, p in params.items():
        if count == 0:
            out[name] = p.new_zeros((0, *p.shape))
        else:
            out[name] = e_par[off:off + p.numel()].T.reshape(count, *p.shape)
        off += p.numel()
    return out


def eigh_dp(
    model_fn,
    loss: Loss,
    group,
    k_top: Optional[int] = None,
    *,
    criterion: Optional[Callable] = None,
    warn_small_eigvals: Optional[float] = 1e-4,
    mc_samples: int = 0,
    precision: str = "highest",
    solver: str = "eigh",
    deflate_ce_null: bool = False,
    return_eig_info: bool = False,
    device=None,
) -> Callable:
    """Build a data-parallel GGN eigenpair function.

    ``fn(params, X_l, y_l, key=None) -> (evals [K], evecs)``, ``evecs`` a
    dict ``{name: [K, *param.shape]}`` (replicated).  The back-projection
    ``e = V ẽ`` is the ``all_reduce`` of each rank's ``V_localᵀ @ rows``,
    normalized by the realized norm.

    Selection:

    * ``k_top``: the top-``k`` by ``solver`` (``"eigh"``, ``"lobpcg"``,
      ``"dc"``);
    * ``criterion``: a host filter of the full ascending spectrum (numpy →
      indices), ``solver`` ``"eigh"`` or ``"dc"``.  The ``Vᵀ`` transform
      runs once: the rank's ``V`` rows built for the Gram serve the
      projection of the selected directions.  An empty selection returns
      empty leaves.  A tripped dc guard warns from the solver itself.
    * ``warn_small_eigvals``: warn when a selected eigenvalue falls below
      it (:func:`vivit_tpu_torch.linalg.utils.warn_if_small`).

    ``deflate_ce_null`` (exact CE): shard-local factor-level deflation, the
    Gram and its solve at ``(C−1)·N`` (the criterion sees that spectrum);
    the back-projection through the deflated ``V`` is exact.  Needs
    ``k_top ≤ (C−1)·N``.  ``return_eig_info``: ``fn`` returns ``(evals,
    evecs, info)``.
    """
    if (k_top is None) == (criterion is None):
        raise ValueError("Pass exactly one of `k_top` or `criterion`.")
    backend = None
    if criterion is not None:
        backend = {"eigh": "xla", "dc": "dc"}.get(solver)
        if backend is None:
            raise ValueError(
                f"solver={solver!r} cannot produce the full spectrum the "
                "criterion filters — use 'eigh' or 'dc'."
            )
    if deflate_ce_null:
        check_deflatable(loss, mc_samples)
    device = _rank_device(group, device)

    def fn(params, X_l, y_l, key=None):
        check_params_on(params, device, "move the params dict to the rank's device first.")
        sh = _shard(group, device, X_l, y_l)
        with matmul_precision(precision):
            vt = ggn_sqrt_vt(model_fn, loss, params, sh.X, sh.y, mc_samples=mc_samples,
                             key=key, column_scale=loss.rho(sh.n_global) ** 0.5,
                             sample_ids=sh.ids, deflate_ce_null=deflate_ce_null)
            v_local = _flatten_vt(vt, list(params))
            cols_local = v_local.shape[0]
            if k_top is not None and k_top > cols_local * sh.k:
                raise ValueError(
                    f"k_top={k_top} exceeds the Gram rank CF·N = {cols_local * sh.k}"
                    + (" (deflated: the top-k would reach the structural null space)"
                       if deflate_ce_null else ""))
            gram = sharded_gram(v_local, group)
            if criterion is None:
                evals, evecs_sel, info = topk_eigh(gram, k_top, solver=solver,
                                                   return_info=True)
            else:
                evals_all, evecs_all, info = full_eigh(gram, backend=backend,
                                                       return_info=True)
                keep = kept_indices(criterion, evals_all)
                evals, evecs_sel = evals_all[keep], evecs_all[:, keep]
            warn_if_small(evals, warn_small_eigvals)
            e_par = None
            if evals.numel():
                e_par = _all_reduce(
                    v_local.T @ _rows_of_rank(evecs_sel, sh.rank, cols_local), group)
                # the realized norm (‖Vẽ‖ = √λ̃ analytically); a sum of
                # squares, which the CPU reduces pairwise, where its f32
                # vector_norm over 10⁶ entries is ~4e-4 off
                e_par = e_par / e_par.square().sum(dim=0, keepdim=True).sqrt()
            out = (evals, _stack_evecs(e_par, params, evals.numel()))
        return (*out, info) if return_eig_info else out

    return fn


def _check_newton_rank(k_top, cf, n_global, subsampling_ggn, deflate_ce_null):
    """Raise when ``k_top`` passes the Gram's rank: a sub-sampled Gram has
    only ``|S|·CF`` nonzero eigenvalues, and dividing by √0 gives NaN
    steps."""
    if subsampling_ggn is not None and k_top > len(subsampling_ggn) * cf:
        raise ValueError(f"k_top={k_top} exceeds the sub-sampled GGN rank "
                         f"|S|·CF = {len(subsampling_ggn) * cf}.")
    if k_top > cf * n_global:
        raise ValueError(f"k_top={k_top} exceeds the Gram rank CF·N = {cf * n_global}"
                         + (" (deflated)" if deflate_ce_null else ""))


def _derivatives_dp(model_fn, loss, params, sh, key, *, group, k_top, mc_samples,
                    group_paths, subsampling_grad, subsampling_ggn, solver,
                    deflate_ce_null, device):
    """The shared body of :func:`directional_derivatives_dp` and
    :func:`newton_step_dp`: per group of parameter names ``(paths, evals
    [K], Gram vectors [cols, K], e_par [D_g, K] = V ẽ / √λ̃, γ_local
    [n_local, K], λ_local [n_local, K], guard info)``."""
    scale, mask = _dp_column_scale(loss, sh.n_global, subsampling_ggn, sh.ids, device)
    s_ggn = sh.n_global if subsampling_ggn is None else len(subsampling_ggn)
    vt = ggn_sqrt_vt(model_fn, loss, params, sh.X, sh.y, mc_samples=mc_samples, key=key,
                     column_scale=scale, sample_ids=sh.ids, deflate_ce_null=deflate_ce_null)
    cf = next(iter(vt.values())).shape[0]
    _check_newton_rank(k_top, cf, sh.n_global, subsampling_ggn, deflate_ce_null)
    if mask is not None:
        vt = _mask_vt(vt, mask)
    # unscaled per-sample gradients ∇ℓ_n (undo BatchGrad's 1/N)
    grads = batch_grad(model_fn, loss, sh.X, sh.y, params=params, batch_size=sh.n_global)
    mask_g = (None if subsampling_grad is None
              else _sample_mask(sh.ids, subsampling_grad, device))

    blocks = []
    for paths in ([list(params)] if group_paths is None else [tuple(p) for p in group_paths]):
        v_local = _flatten_vt(vt, paths)  # [cols_local, D_g]
        cols_local = v_local.shape[0]
        gram = sharded_gram(v_local, group)
        evals, evecs, info = topk_eigh(gram, k_top, solver=solver, return_info=True)
        e_par = _all_reduce(v_local.T @ _rows_of_rank(evecs, sh.rank, cols_local), group)
        e_par = e_par / torch.sqrt(evals)[None, :]
        g_local = torch.cat([grads[p].reshape(sh.n_local, -1) * sh.n_global
                             for p in paths], dim=1)
        gammas = g_local @ e_par  # [n_local, K]
        if mask_g is not None:
            gammas = gammas * mask_g[:, None]
        # λ_n = S_ggn·‖V_nᵀ e‖² (V rows carry √(1/S_ggn)); masked samples give 0
        proj = torch.einsum("cnd,dk->cnk", v_local.reshape(cf, sh.n_local, -1), e_par)
        lambdas = s_ggn * (proj ** 2).sum(dim=0)
        blocks.append((paths, evals, evecs, e_par, gammas, lambdas, info))
    return blocks


def directional_derivatives_dp(
    model_fn,
    loss: Loss,
    group,
    k_top: int,
    *,
    mc_samples: int = 0,
    precision: str = "highest",
    group_paths: Optional[Sequence[Sequence[str]]] = None,
    subsampling_grad: Optional[Sequence[int]] = None,
    subsampling_ggn: Optional[Sequence[int]] = None,
    solver: str = "eigh",
    deflate_ce_null: bool = False,
    return_eig_info: bool = False,
    device=None,
) -> Callable:
    """Build a data-parallel directional-derivatives function, the
    counterpart of :func:`vivit_tpu_torch.optim.directional_derivatives_topk`.

    ``fn(params, X_l, y_l, key=None) -> (evals [K], gammas [n_local, K],
    lambdas [n_local, K])``: the eigenvalues are replicated; **γ and λ are
    this rank's rows** (its samples, in local order; the JAX package
    returns the global arrays sharded over the batch, which is the same
    data).  ``subsampling_grad``/``subsampling_ggn`` take global indices;
    rows of non-selected samples are exact zeros.  ``group_paths``:
    per-group results as tuples.  ``deflate_ce_null`` (exact CE): the
    collectives and the solve at ``(C−1)·N``, γ/λ exact.
    ``return_eig_info``: also the guard info.
    """
    if loss.reduction != "mean":
        raise ValueError("Directional derivatives require reduction='mean' "
                         "(same restriction as the reference).")
    check_subsampling_unique(subsampling_grad)
    check_subsampling_unique(subsampling_ggn)
    if deflate_ce_null:
        check_deflatable(loss, mc_samples)
    device = _rank_device(group, device)

    def fn(params, X_l, y_l, key=None):
        check_params_on(params, device, "move the params dict to the rank's device first.")
        sh = _shard(group, device, X_l, y_l)
        with matmul_precision(precision):
            blocks = _derivatives_dp(
                model_fn, loss, params, sh, key, group=group, k_top=k_top,
                mc_samples=mc_samples, group_paths=group_paths,
                subsampling_grad=subsampling_grad, subsampling_ggn=subsampling_ggn,
                solver=solver, deflate_ce_null=deflate_ce_null, device=device)
        parts = [tuple(b[i] for b in blocks) for i in (1, 4, 5, 6)]
        if group_paths is None:
            parts = [p[0] for p in parts]
        return tuple(parts) if return_eig_info else tuple(parts[:3])

    return fn


def newton_step_dp(
    model_fn,
    loss: Loss,
    group,
    k_top: int,
    damping=1.0,
    *,
    mc_samples: int = 0,
    precision: str = "highest",
    group_paths: Optional[Sequence[Sequence[str]]] = None,
    subsampling_grad: Optional[Sequence[int]] = None,
    subsampling_ggn: Optional[Sequence[int]] = None,
    solver: str = "eigh",
    deflate_ce_null: bool = False,
    return_eig_info: bool = False,
    device=None,
) -> Callable:
    """Build a data-parallel damped-Newton step (the full DP pipeline).

    ``fn(params, X_l, y_l, key=None) -> (evals [K], step)``, ``step`` a dict
    like ``params`` (replicated): per-rank ``Vᵀ`` and per-sample gradients,
    the Gram's ``all_reduce``, the replicated top-``k`` (``solver``
    ``"eigh"``, ``"lobpcg"`` or ``"dc"``), γ/λ on each rank, their means
    and the parameter-space step ``all_reduce``-assembled.  The step of
    :func:`vivit_tpu_torch.optim.newton_step_topk` on the global batch.

    ``group_paths``: per-group directions and steps; the result is
    ``(evals tuple, steps tuple)``, each step a list of tensors in the
    group's name order.  ``subsampling_grad``/``subsampling_ggn``: global
    indices (non-selected GGN columns zeroed on their rank).  ``damping``: a
    scalar or a callable ``(evals [K], gram_evecs [cols, K], gammas [N, K],
    lambdas [N, K]) → δ [K]``; γ/λ are gathered into global sample order
    for it (rows of non-selected samples are zeros: divide by ``|S|``, not
    the length).  ``deflate_ce_null`` (exact CE): the collectives and the
    solve at ``(C−1)·N``, γ/λ/step exact; needs ``k_top ≤ (C−1)·N_ggn``.
    ``return_eig_info``: also the guard info, one per group.
    """
    if loss.reduction != "mean":
        raise ValueError("Newton step requires reduction='mean'.")
    check_subsampling_unique(subsampling_grad)
    check_subsampling_unique(subsampling_ggn)
    if deflate_ce_null:
        check_deflatable(loss, mc_samples)
    device = _rank_device(group, device)

    def fn(params, X_l, y_l, key=None):
        check_params_on(params, device, "move the params dict to the rank's device first.")
        sh = _shard(group, device, X_l, y_l)
        s_grad = sh.n_global if subsampling_grad is None else len(subsampling_grad)
        s_ggn = sh.n_global if subsampling_ggn is None else len(subsampling_ggn)
        evs, steps, infos = [], [], []
        with matmul_precision(precision):
            blocks = _derivatives_dp(
                model_fn, loss, params, sh, key, group=group, k_top=k_top,
                mc_samples=mc_samples, group_paths=group_paths,
                subsampling_grad=subsampling_grad, subsampling_ggn=subsampling_ggn,
                solver=solver, deflate_ce_null=deflate_ce_null, device=device)
            for paths, evals, evecs, e_par, gammas, lambdas, info in blocks:
                sums = _all_reduce(torch.stack([gammas.sum(dim=0), lambdas.sum(dim=0)]),
                                   group)
                if callable(damping):
                    # the reference protocol: per-sample γ/λ in global order
                    delta = damping(evals, evecs,
                                    _all_gather(gammas, group, sh.k).reshape(-1, k_top),
                                    _all_gather(lambdas, group, sh.k).reshape(-1, k_top))
                else:
                    delta = damping
                step_flat = e_par @ (-(sums[0] / s_grad) / (sums[1] / s_ggn + delta))
                if group_paths is None:
                    steps.append(unravel_like(step_flat, params))
                else:
                    steps.append(list(unravel_like(
                        step_flat, dict(select_paths(params, paths))).values()))
                evs.append(evals)
                infos.append(info)
        if group_paths is None:
            out = (evs[0], steps[0], infos[0])
        else:
            out = (tuple(evs), tuple(steps), tuple(infos))
        return out if return_eig_info else out[:2]

    return fn


def newton_step_dp_structured(
    module,
    loss: Loss,
    group,
    k_top: int,
    damping=1.0,
    *,
    mc_samples: int = 0,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    solver: str = "eigh",
    deflate_ce_null: bool = False,
    engine: str = "tapped",
    conv_vt_dtype: Optional[torch.dtype] = None,
    device=None,
) -> Callable:
    """Data-parallel damped-Newton step with the structured V-transform of
    an ``nn.Module``, the counterpart of
    :func:`vivit_tpu_torch.structured.newton_step_structured`.

    ``fn(X_l, y_l, key=None) -> (evals [K], step)``, ``step`` one tensor per
    parameter in ``named_parameters`` order.  Dense ``(z, δ)`` blocks stay
    factored per rank: the Gram from :func:`_structured_gram_dp`, the
    back-projection ``V ẽ`` and ``Vᵀ e`` per rank
    (:func:`~vivit_tpu_torch.structured.v_mat_prod_mixed`,
    :func:`~vivit_tpu_torch.structured.vt_mat_prod_mixed`), the directions
    ``all_reduce``-assembled.  ``damping``, ``solver`` and
    ``deflate_ce_null`` as in :func:`newton_step_dp`; ``engine``,
    ``conv_vt_dtype`` and ``gram_precision`` as in
    :func:`eigvalsh_dp_structured`.
    """
    if loss.reduction != "mean":
        raise ValueError("Newton step requires reduction='mean'.")
    if deflate_ce_null:
        check_deflatable(loss, mc_samples)
    gp = _PRECISIONS[gram_precision]
    device = _rank_device(group, device)

    def fn(X_l, y_l, key=None):
        from vivit_tpu_torch.structured import (
            structured_ggn_sqrt_vt,
            v_mat_prod_mixed,
            vt_mat_prod_mixed,
        )

        check_module_on(module, device)
        sh = _shard(group, device, X_l, y_l)
        paths = [name for name, _ in module.named_parameters()]
        with matmul_precision(precision):
            vt = structured_ggn_sqrt_vt(module, loss, sh.X, sh.y, mc_samples=mc_samples,
                                        key=key, sample_ids=sh.ids,
                                        deflate_ce_null=deflate_ce_null, engine=engine,
                                        conv_vt_dtype=conv_vt_dtype)
            # the local √ρ(n_local) column scale → the global √ρ(N)
            vt = _scale_cols_mixed(vt, (loss.rho(sh.n_global) / loss.rho(sh.n_local)) ** 0.5)
            gram = _structured_gram_dp(vt, 1.0, group, gp)
            if k_top > gram.shape[0]:
                raise ValueError(f"k_top={k_top} exceeds the Gram rank CF·N = "
                                 f"{gram.shape[0]}" + (" (deflated)" if deflate_ce_null else ""))
            evals, evecs = topk_eigh(gram, k_top, solver=solver)
            cols_local = _num_cols_mixed(vt[paths[0]])
            cf = cols_local // sh.n_local
            rows = _rows_of_rank(evecs, sh.rank, cols_local).T  # [K, cols_local]

            # parameter-space directions: one all_reduce of the factored
            # back-projections, then 1/√λ̃
            leaves = v_mat_prod_mixed(vt, rows, paths)
            flat = _all_reduce(torch.cat([e.reshape(k_top, -1) for e in leaves], dim=1),
                               group) / torch.sqrt(evals)[:, None]
            e_leaves = [part.reshape(e.shape) for part, e in
                        zip(flat.split([e[0].numel() for e in leaves], dim=1), leaves)]

            # γ: unscaled local per-sample gradients against the directions
            grads = batch_grad(module, loss, sh.X, sh.y, batch_size=sh.n_global)
            gammas = sum(grads[p].reshape(sh.n_local, -1) * sh.n_global
                         @ e.reshape(k_top, -1).T for p, e in zip(paths, e_leaves))
            # λ: Vᵀe stays factored per rank → [cols_local, K]
            proj = vt_mat_prod_mixed(vt, e_leaves, paths).reshape(cf, sh.n_local, -1)
            lambdas = sh.n_global * (proj ** 2).sum(dim=0)
            means = _all_reduce(torch.stack([gammas.mean(dim=0), lambdas.mean(dim=0)]),
                                group) / sh.k
            if callable(damping):
                delta = damping(evals, evecs,
                                _all_gather(gammas, group, sh.k).reshape(-1, k_top),
                                _all_gather(lambdas, group, sh.k).reshape(-1, k_top))
            else:
                delta = damping
            coeff = -means[0] / (means[1] + delta)  # [K]
            return evals, [torch.tensordot(coeff, e, dims=1) for e in e_leaves]

    return fn


def train_step_dp(
    model_fn,
    loss: Loss,
    group,
    k_top: int,
    damping: float = 1.0,
    lr: float = 1.0,
    **kwargs,
) -> Callable:
    """Data-parallel second-order training step ``params ← params + lr·s``
    (:func:`newton_step_dp`; ``kwargs`` go to it).  Returns
    ``step(params, X_l, y_l, key=None) -> (new_params, evals)``."""
    newton = newton_step_dp(model_fn, loss, group, k_top, damping, **kwargs)

    def step(params, X_l, y_l, key=None):
        evals, s = newton(params, X_l, y_l, key)
        return {name: p + lr * s[name] for name, p in params.items()}, evals

    return step


# streamed × DP composition (imports back from this module, so keep last)
from vivit_tpu_torch.parallel.streamed import (  # noqa: E402
    eigvalsh_streamed_dp,
    gram_streamed_shard,
)

__all__ = [
    "directional_derivatives_dp",
    "eigh_dp",
    "eigvalsh_dp",
    "eigvalsh_dp_structured",
    "eigvalsh_streamed_dp",
    "gram_streamed_shard",
    "newton_step_dp",
    "newton_step_dp_structured",
    "sharded_gram",
    "train_step_dp",
]
