"""Memory-frugal Gram assembly: factor-axis streaming of the generic ``Vᵀ``
(counterpart of ``vivit_tpu/chunked.py``).

The generic exact-GGN ``Vᵀ`` is ``[CF, S, D]``: for CIFAR-10 3c3d at
``N = 512`` that is 18.3 GB (16.5 GB deflated).  The stream keeps at most
**two** single-factor slices ``[S, D]`` alive and contracts each Gram block
``G[(i,·),(j,·)] = V_iᵀ V_j`` as it appears.

Loop, as in the JAX package: ``i`` outer; ``j ≤ i`` inner with the ``j``
slice recomputed (``j = i`` too), the block of ``j < i`` mirrored; ``Vᵀg``
taken while the ``i`` slice is resident.  That is ``CF + CF·(CF+1)/2``
backward passes, ``(CF−1) + (CF−1)·CF/2`` with ``deflate_ce_null`` (54 for
CE with C=10), instead of the in-memory engine's ``CF``: compute traded for
memory.  Each slice is freed as soon as it is used.
:func:`eigh_topk_streamed` streams the factors once more for the
back-projection ``V ẽ``, :func:`newton_step_streamed` for the step's
``V``-application.

The model is a model function ``model_fn(params, X)`` with its ``params``
dict, or an ``nn.Module`` with ``params=None`` (through its
``functional_call``); every slice is the generic engine's
(:func:`vivit_tpu_torch.ggn.pullback`).  The pipelines run on ``device``
(default the CUDA card); :func:`gram_streamed` and
:func:`backproject_streamed` run where their inputs lie.
"""

from typing import Dict, List, Optional, Sequence

import torch

from vivit_tpu_torch.losses import Loss
from vivit_tpu_torch.utils.checks import check_subsampling_unique
from vivit_tpu_torch.utils.tree import select_paths


def _vt_single_factor(model_fn, params, Xs, s_rows) -> Dict[str, torch.Tensor]:
    """``Vᵀ`` slice of one factor column, ``{name: [S, *shape]}``, from the
    loss-factor rows ``s_rows [S, C]`` of that column."""
    from vivit_tpu_torch.ggn import pullback

    columns = pullback(model_fn, params, Xs, s_rows[:, None])
    return {name: c[:, 0] for name, c in columns.items()}


def _flat(leaf: torch.Tensor) -> torch.Tensor:
    return leaf.reshape(leaf.shape[0], -1)


def _pair_block(vt_i, vt_j, paths, precision=None) -> torch.Tensor:
    """``[S, S]`` Gram block ``V_iᵀ V_j`` summed over the selected leaves;
    ``precision`` is the operand dtype (:func:`vivit_tpu_torch.precision.dot_t`)."""
    from vivit_tpu_torch.precision import dot_t

    total = None
    for (_, a), (_, b) in zip(select_paths(vt_i, paths), select_paths(vt_j, paths)):
        g = dot_t(_flat(a), _flat(b), precision)
        total = g if total is None else total + g
    return total


def _vtg_block(vt_i, grad_leaves, paths, precision=None) -> torch.Tensor:
    """``[S, N_grad]`` block ``V_iᵀ g`` summed over the selected leaves."""
    from vivit_tpu_torch.precision import dot_t

    total = None
    for (_, a), g in zip(select_paths(vt_i, paths), grad_leaves):
        r = dot_t(_flat(a), _flat(g), precision)
        total = r if total is None else total + r
    return total


def _prepare_factors(model, loss, params, X, y, *, paths, subsampling, mc_samples,
                     key, batch_size, deflate_ce_null=False):
    """Shared stream set-up: ``(model_fn, params, paths, Xs, scaled factors
    [S, CF, C])``, the factors those of
    :func:`vivit_tpu_torch.ggn.v_factors` (with ``deflate_ce_null`` projected
    onto the CE null complement, ``CF = C − 1``)."""
    from vivit_tpu_torch.engines import resolve_model
    from vivit_tpu_torch.ggn import _sample_ids, _subsample, v_factors

    check_subsampling_unique(subsampling)
    model_fn, params = resolve_model(model, params)
    params = {name: p.detach() for name, p in params.items()}
    if paths is None:
        paths = list(params)
    N = batch_size if batch_size is not None else X.shape[0]
    sample_ids = _sample_ids(X, subsampling, None)
    Xs, ys = _subsample(X, y, subsampling)
    with torch.no_grad():
        f = model_fn(params, Xs)
    factors = v_factors(loss, f, ys, batch_size=N, mc_samples=mc_samples, key=key,
                        sample_ids=sample_ids, deflate_ce_null=deflate_ce_null)
    return model_fn, params, tuple(paths), Xs, factors


def gram_streamed(
    model,
    loss: Loss,
    params: Optional[Dict[str, torch.Tensor]],
    X: torch.Tensor,
    y: torch.Tensor,
    *,
    paths: Optional[Sequence[str]] = None,
    subsampling: Optional[Sequence[int]] = None,
    mc_samples: int = 0,
    key: Optional[int] = None,
    batch_size: Optional[int] = None,
    precision=None,
    grad_leaves: Optional[Sequence[torch.Tensor]] = None,
    deflate_ce_null: bool = False,
):
    """``[CF·S, CF·S]`` GGN Gram without the full ``Vᵀ``: the Gram of
    :func:`vivit_tpu_torch.ggn.ggn_sqrt_vt` (same scaling, same ``c·S + n``
    layout) from at most two ``[S, D]`` slices at a time.

    ``precision`` is the blocks' operand dtype (``None`` full f32,
    ``torch.bfloat16``: the in-memory bf16 Gram's arithmetic).
    ``grad_leaves`` (``[N_grad, *shape]`` tensors in ``paths`` order): also
    accumulate ``Vᵀ g`` while each ``i`` slice is resident and return
    ``(gram, v_t_g [CF·S, N_grad])``.  ``deflate_ce_null``: the exactly
    deflated ``[(C−1)·S]²`` Gram, from one factor slice fewer.
    """
    model_fn, params, paths, Xs, factors = _prepare_factors(
        model, loss, params, X, y, paths=paths, subsampling=subsampling,
        mc_samples=mc_samples, key=key, batch_size=batch_size,
        deflate_ce_null=deflate_ce_null)
    S, cf = Xs.shape[0], factors.shape[1]
    gram = torch.zeros((cf * S, cf * S), dtype=torch.float32, device=Xs.device)
    vtg = (None if grad_leaves is None else
           torch.zeros((cf * S, grad_leaves[0].shape[0]), dtype=torch.float32,
                       device=Xs.device))
    for i in range(cf):
        vt_i = _vt_single_factor(model_fn, params, Xs, factors[:, i])
        rows = slice(i * S, (i + 1) * S)
        if grad_leaves is not None:
            vtg[rows] = _vtg_block(vt_i, grad_leaves, paths, precision)
        for j in range(i + 1):
            vt_j = _vt_single_factor(model_fn, params, Xs, factors[:, j])
            block = _pair_block(vt_i, vt_j, paths, precision)
            del vt_j
            gram[rows, j * S:(j + 1) * S] = block
            if j < i:
                gram[j * S:(j + 1) * S, rows] = block.T
        del vt_i
    return gram if grad_leaves is None else (gram, vtg)


def backproject_streamed(model_fn, params: Dict[str, torch.Tensor], Xs: torch.Tensor,
                         factors: torch.Tensor, paths: Sequence[str],
                         weights: torch.Tensor) -> List[torch.Tensor]:
    """``V @ w`` for column-stacked Gram-space weights ``[CF·S, K]``, one
    ``[K, *param.shape]`` tensor per path: accumulated factor by factor, one
    ``[S, D]`` slice and the ``[K, D]`` sum alive at a time (the streamed
    :func:`vivit_tpu_torch.gram.v_mat_prod`)."""
    S, cf = Xs.shape[0], factors.shape[1]
    out = None
    for i in range(cf):
        vt_i = _vt_single_factor(model_fn, params, Xs, factors[:, i])
        w_i = weights[i * S:(i + 1) * S]
        leaves = [(w_i.T @ _flat(leaf)).reshape(w_i.shape[1], *leaf.shape[1:])
                  for _, leaf in select_paths(vt_i, paths)]
        del vt_i
        out = leaves if out is None else [a + b for a, b in zip(out, leaves)]
    return out


def _check_rank(k: int, factors: torch.Tensor, deflate_ce_null: bool) -> None:
    rank = factors.shape[0] * factors.shape[1]
    if k > rank:
        raise ValueError(
            f"k={k} exceeds the Gram rank CF·S = {rank}"
            + (" (deflated: the top-k would reach the structural null space)"
               if deflate_ce_null else ""))


def eigvalsh_streamed(
    model,
    loss: Loss,
    params: Optional[Dict[str, torch.Tensor]],
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
    device=None,
):
    """GGN eigenvalues per group of parameter names in the streamed memory
    mode: the result of :func:`vivit_tpu_torch.linalg.eigvalsh` for batches
    whose full ``Vᵀ`` does not fit (one stream per group).

    ``eig_backend``: ``"xla"`` (``torch.linalg.eigh``) or ``"dc"``
    (:mod:`vivit_tpu_torch.eigdc`, guarded).  ``deflate_ce_null`` (exact CE)
    solves the ``(C−1)·S`` Gram of a stream one slice shorter and returns the
    ``S`` structural zeros exactly.
    """
    from vivit_tpu_torch.eig import full_eigh
    from vivit_tpu_torch.engines import resolve_model
    from vivit_tpu_torch.precision import _PRECISIONS, matmul_precision
    from vivit_tpu_torch.utils.device import inputs_on

    if deflate_ce_null:
        from vivit_tpu_torch.deflate import check_deflatable

        check_deflatable(loss, mc_samples)
    X, y = inputs_on(model, X, y, device, params=params)
    if group_paths is None:
        group_paths = (tuple(resolve_model(model, params)[1]),)
    s = X.shape[0] if subsampling is None else len(subsampling)
    evals = []
    with matmul_precision(precision):
        for paths in group_paths:
            gram = gram_streamed(model, loss, params, X, y, paths=tuple(paths),
                                 subsampling=subsampling, mc_samples=mc_samples, key=key,
                                 precision=_PRECISIONS[gram_precision],
                                 deflate_ce_null=deflate_ce_null)
            ev = full_eigh(gram, backend=eig_backend, eigenvectors=False)[0]
            if deflate_ce_null:
                ev = torch.sort(torch.cat([ev.new_zeros(s), ev])).values
            evals.append(ev)
    return tuple(evals)


def eigh_topk_streamed(
    model,
    loss: Loss,
    params: Optional[Dict[str, torch.Tensor]],
    X,
    y,
    k: int,
    *,
    paths: Optional[Sequence[str]] = None,
    subsampling: Optional[Sequence[int]] = None,
    mc_samples: int = 0,
    key: Optional[int] = None,
    batch_size: Optional[int] = None,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    eig_backend: str = "xla",
    deflate_ce_null: bool = False,
    device=None,
):
    """Top-``k`` GGN eigenpairs in the streamed memory mode: ``(evals [k]
    ascending, [k, *param.shape] per path)``, the result of
    :func:`vivit_tpu_torch.linalg.eigh_topk`.  One stream builds the Gram,
    the eigendecomposition is dense (``eig_backend``), a second stream
    back-projects ``V ẽ``.  ``deflate_ce_null`` (exact CE): both streams
    one slice shorter, exact (the deflated ``V`` spans every nonzero
    eigenvector); it needs ``k ≤ (C−1)·S``.
    """
    from vivit_tpu_torch.eig import full_eigh
    from vivit_tpu_torch.gram import normalize
    from vivit_tpu_torch.precision import _PRECISIONS, matmul_precision
    from vivit_tpu_torch.utils.device import inputs_on

    if deflate_ce_null:
        from vivit_tpu_torch.deflate import check_deflatable

        check_deflatable(loss, mc_samples)
    X, y = inputs_on(model, X, y, device, params=params)
    with matmul_precision(precision):
        model_fn, fwd_params, paths, Xs, factors = _prepare_factors(
            model, loss, params, X, y, paths=paths, subsampling=subsampling,
            mc_samples=mc_samples, key=key, batch_size=batch_size,
            deflate_ce_null=deflate_ce_null)
        _check_rank(k, factors, deflate_ce_null)
        gram = gram_streamed(model, loss, params, X, y, paths=paths,
                             subsampling=subsampling, mc_samples=mc_samples, key=key,
                             batch_size=batch_size, precision=_PRECISIONS[gram_precision],
                             deflate_ce_null=deflate_ce_null)
        evals, evecs = full_eigh(gram, backend=eig_backend)
        del gram
        leaves = backproject_streamed(model_fn, fwd_params, Xs, factors, paths,
                                      evecs[:, -k:])
        return evals[-k:], normalize(leaves)


def newton_step_streamed(
    model,
    loss: Loss,
    params: Optional[Dict[str, torch.Tensor]],
    X,
    y,
    k: int,
    damping=1.0,
    *,
    paths: Optional[Sequence[str]] = None,
    subsampling_grad: Optional[Sequence[int]] = None,
    subsampling_ggn: Optional[Sequence[int]] = None,
    mc_samples_ggn: int = 0,
    key: Optional[int] = None,
    batch_size: Optional[int] = None,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    eig_backend: str = "xla",
    deflate_ce_null: bool = False,
    device=None,
) -> List[torch.Tensor]:
    """Damped Newton step along the top-``k`` GGN directions in the
    streamed memory mode, one tensor per path: the result of
    :func:`vivit_tpu_torch.optim.newton_step_topk`, ``damping`` a scalar or
    a callable ``(evals, gram_evecs, gammas, lambdas) -> δ [k]``.  The Gram
    stream takes ``Vᵀ g`` on each resident ``i`` slice; one more stream
    applies ``V`` to the Gram-space step.  Peak memory: two ``[S, D]``
    slices and the per-sample gradients.  ``deflate_ce_null`` (exact CE):
    γ, λ and the step stay exact; it needs ``k ≤ (C−1)·S``.
    """
    from vivit_tpu_torch.eig import full_eigh
    from vivit_tpu_torch.ggn import batch_grad
    from vivit_tpu_torch.optim.utils import gammas_lambdas
    from vivit_tpu_torch.precision import _PRECISIONS, matmul_precision
    from vivit_tpu_torch.utils.device import inputs_on

    if loss.reduction != "mean":
        raise ValueError("Newton step requires reduction='mean' "
                         "(same restriction as the reference).")
    check_subsampling_unique(subsampling_grad)
    if deflate_ce_null:
        from vivit_tpu_torch.deflate import check_deflatable

        check_deflatable(loss, mc_samples_ggn)
    X, y = inputs_on(model, X, y, device, params=params)
    with matmul_precision(precision):
        N = batch_size if batch_size is not None else X.shape[0]
        model_fn, fwd_params, paths, Xs, factors = _prepare_factors(
            model, loss, params, X, y, paths=paths, subsampling=subsampling_ggn,
            mc_samples=mc_samples_ggn, key=key, batch_size=batch_size,
            deflate_ce_null=deflate_ce_null)
        S = Xs.shape[0]
        _check_rank(k, factors, deflate_ce_null)
        grads = batch_grad(model_fn, loss, X, y, params=fwd_params,
                           subsampling=subsampling_grad, batch_size=N)
        # undo the 1/N BatchGrad convention: unscaled per-sample gradients
        grad_leaves = [grads[p] * N for p in paths]
        del grads
        gram, v_t_g = gram_streamed(
            model, loss, params, X, y, paths=paths, subsampling=subsampling_ggn,
            mc_samples=mc_samples_ggn, key=key, batch_size=batch_size,
            precision=_PRECISIONS[gram_precision], grad_leaves=grad_leaves,
            deflate_ce_null=deflate_ce_null)
        del grad_leaves
        evals, evecs = full_eigh(gram, backend=eig_backend)
        evals_sel, evecs_sel = evals[-k:], evecs[:, -k:]
        gammas, lambdas = gammas_lambdas(gram, evals_sel, evecs_sel, v_t_g, S)
        delta = damping(evals_sel, evecs_sel, gammas, lambdas) if callable(damping) else damping
        coefficients = (-gammas.mean(dim=0) / (lambdas.mean(dim=0) + delta)
                        / torch.sqrt(evals_sel))
        v = evecs_sel @ coefficients  # [CF·S]
        leaves = backproject_streamed(model_fn, fwd_params, Xs, factors, paths, v[:, None])
        return [leaf[0] for leaf in leaves]
