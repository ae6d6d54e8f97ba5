"""Streamed × data-parallel composition: factor streaming on every rank
(counterpart of ``vivit_tpu/parallel/streamed.py``).

The single-device stream (:mod:`vivit_tpu_torch.chunked`) keeps at most two
``[S, D]`` factor slices alive; the DP pipelines (:mod:`vivit_tpu_torch.parallel`)
shard the batch but materialize each rank's ``Vᵀ [CF, S_local, D]``.  This
module composes the two, per factor slice:

1. rank ``r`` computes its local slice ``V_iᵀ[r] = [S_local, D]`` (one
   per-sample vjp, :func:`vivit_tpu_torch.ggn.pullback`),
2. ``all_to_all_single`` reshards it to ``[S_global, D/k]``, the same
   per-rank footprint, so the two-slice memory bound holds,
3. each factor pair ``(i, j ≤ i)`` contracts one partial ``[S_g, S_g]``
   block, the ``i`` slice reused for ``j = i``,
4. one ``all_reduce`` at the end sums the ``[CF·S_g, CF·S_g]`` Gram.

Cost: ``CF + CF·(CF−1)/2`` backward passes per rank over its shard (45 for
deflated CE at C=10, where the single-device stream makes 54) and as many
``[S_local, D]`` exchanges.  The Gram's column order is ``(cf, rank,
local_sample)``, a permutation of both the single-device ``(cf, sample)``
and the materialized DP ``(rank, cf, sample)`` orders.
"""

from typing import Callable, Optional, Sequence

import torch

from vivit_tpu_torch.deflate import check_deflatable
from vivit_tpu_torch.ggn import pullback, v_factors
from vivit_tpu_torch.losses import Loss
from vivit_tpu_torch.parallel import (
    _dp_column_scale,
    _all_reduce,
    _rank_device,
    _reshard_cols,
    _shard,
    _solve_spectrum,
    _spectra_result,
    _world,
)
from vivit_tpu_torch.precision import _PRECISIONS, dot_t, matmul_precision
from vivit_tpu_torch.utils.checks import check_subsampling_unique
from vivit_tpu_torch.utils.device import as_batch, check_params_on


def _vt_slice_flat(model_fn, params, X_l, s_rows, paths) -> torch.Tensor:
    """One factor's local ``Vᵀ`` slice flattened to ``[S_local, D_group]``
    (``s_rows [S_local, C]``: that factor's scaled loss-factor rows)."""
    columns = pullback(model_fn, params, X_l, s_rows[:, None])
    return torch.cat([columns[p][:, 0].reshape(X_l.shape[0], -1) for p in paths], dim=1)


def gram_streamed_shard(
    model_fn,
    loss: Loss,
    params,
    X_l: torch.Tensor,
    y_l: torch.Tensor,
    *,
    group=None,
    paths: Sequence[str],
    subsampling: Optional[Sequence[int]] = None,
    mc_samples: int = 0,
    key: Optional[int] = None,
    precision=None,
    deflate_ce_null: bool = False,
) -> torch.Tensor:
    """Global ``[CF·S_g, CF·S_g]`` Gram, factor-streamed on every rank.

    Every rank of ``group`` calls it with its shard ``X_l, y_l`` (tensors on
    its device).  At most two resharded ``[S_global, D/k]`` slices are alive
    per rank.  Scaling and masking as in
    :func:`vivit_tpu_torch.parallel.eigvalsh_dp` (``√ρ(N)`` columns,
    zero-masked non-selected samples of the global-index ``subsampling``);
    ``deflate_ce_null`` projects each shard's factors, so the stream is one
    slice shorter and the Gram ``((C−1)/C)²`` smaller.  ``precision`` is the
    blocks' operand dtype (:func:`vivit_tpu_torch.precision.dot_t`).
    """
    sh = _shard(group, X_l.device, X_l, y_l)
    params = {name: p.detach() for name, p in params.items()}
    scale, mask = _dp_column_scale(loss, sh.n_global, subsampling, sh.ids, X_l.device)
    with torch.no_grad():
        f = model_fn(params, sh.X)
    factors = v_factors(loss, f, sh.y, batch_size=sh.n_global, mc_samples=mc_samples,
                        key=key, sample_ids=sh.ids, column_scale=scale,
                        deflate_ce_null=deflate_ce_null)  # [S_local, CF', C]
    if mask is not None:
        factors = factors * mask[:, None, None]

    cf, s_g = factors.shape[1], sh.n_global
    gram = torch.zeros((cf * s_g, cf * s_g), dtype=torch.float32, device=X_l.device)

    def slice_rs(i):
        return _reshard_cols(_vt_slice_flat(model_fn, params, sh.X, factors[:, i], paths),
                             group, sh.k)

    for i in range(cf):
        vt_i = slice_rs(i)
        rows = slice(i * s_g, (i + 1) * s_g)
        for j in range(i + 1):
            vt_j = vt_i if j == i else slice_rs(j)
            block = dot_t(vt_i, vt_j, precision)
            del vt_j
            gram[rows, j * s_g:(j + 1) * s_g] = block
            if j < i:
                gram[j * s_g:(j + 1) * s_g, rows] = block.T
        del vt_i
    return _all_reduce(gram, group)


def eigvalsh_streamed_dp(
    model_fn,
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
    device=None,
) -> Callable:
    """Build a data-parallel GGN eigenvalue function in the streamed memory
    mode: the result of :func:`vivit_tpu_torch.parallel.eigvalsh_dp` (and of
    :func:`vivit_tpu_torch.chunked.eigvalsh_streamed` on the global batch)
    for batches whose per-rank ``Vᵀ`` does not fit.

    ``fn(params, X_l, y_l, key=None) -> evals``, one stream
    (:func:`gram_streamed_shard`) per group.  Every
    :func:`~vivit_tpu_torch.parallel.eigvalsh_dp` knob carries over:
    ``group_paths``, global-index ``subsampling``, ``mc_samples`` (draws by
    global sample id, layout invariant), ``eig_backend="dc"``, shard-local
    ``deflate_ce_null`` and ``return_eig_info``; ``gram_precision`` demotes
    the blocks' operands (``"bf16"``).
    """
    check_subsampling_unique(subsampling)
    if deflate_ce_null:
        check_deflatable(loss, mc_samples)
    gp = _PRECISIONS[gram_precision]
    device = _rank_device(group, device)

    def fn(params, X_l, y_l, key=None):
        check_params_on(params, device, "move the params dict to the rank's device first.")
        X_l, y_l = as_batch(X_l, y_l, device)
        n_global = X_l.shape[0] * _world(group)[1]
        groups = [list(params)] if group_paths is None else [tuple(p) for p in group_paths]
        with matmul_precision(precision):
            solved = [_solve_spectrum(
                gram_streamed_shard(model_fn, loss, params, X_l, y_l, group=group,
                                    paths=paths, subsampling=subsampling,
                                    mc_samples=mc_samples, key=key, precision=gp,
                                    deflate_ce_null=deflate_ce_null),
                eig_backend, n_global if deflate_ce_null else 0) for paths in groups]
        return _spectra_result(solved, group_paths is not None, return_eig_info)

    return fn
