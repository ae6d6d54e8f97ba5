"""Gram-space pipeline shared by the directional-derivative computations
(counterpart of ``vivit_tpu/optim/utils.py``).  The model is an
``nn.Module`` or a model function ``model_fn(params, X)`` with a
``params`` dict (:mod:`vivit_tpu_torch.engines`).

Math (mean reduction, ``ρ = 1/N``):

* ``V`` columns are ``√(1/S_ggn) · J_nᵀ s_{n,c}`` over the GGN sub-sample
  (the ``√(N/S)`` correction is folded in by the V-transform);
* ``γ[n, k] = g_nᵀ e_k = (Vᵀ g_n)ᵀ ẽ_k / √λ̃_k`` with the unscaled
  per-sample gradient ``g_n = ∇ℓ_n``;
* ``λ[n, k] = e_kᵀ (J_nᵀ H_n J_n) e_k = S_ggn · ‖G̃[(:, n), :] ẽ_k‖² / λ̃_k``.
"""

from typing import Dict, Optional, Sequence, Tuple

import torch

from vivit_tpu_torch.losses import Loss


def derivatives_stage1(
    model,
    loss: Loss,
    X: torch.Tensor,
    y: torch.Tensor,
    *,
    params: Optional[Dict[str, torch.Tensor]] = None,
    group_paths: Sequence[Sequence[str]],
    subsampling_grad: Optional[Sequence[int]] = None,
    subsampling_ggn: Optional[Sequence[int]] = None,
    mc_samples_ggn: int = 0,
    key: Optional[int] = None,
    batch_size: Optional[int] = None,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    compute_eigh: bool = True,
    eig_backend: str = "xla",
    deflate_ce_null: bool = False,
    engine: str = "tapped",
    conv_vt_dtype: Optional[torch.dtype] = None,
    solver: str = "eigh",
    k_top: Optional[int] = None,
    lobpcg_iters: int = 100,
):
    """Stage 1: ``Vᵀ`` (:func:`vivit_tpu_torch.engines.build_vt`: the
    structured engine of a module, by ``engine``, its conv blocks in
    ``conv_vt_dtype``, or the generic engine of a model function;
    Monte-Carlo factors with ``mc_samples_ggn`` and ``key``), and for each
    group of parameter names its Gram, eigenpairs and ``Vᵀ G``.

    Returns ``(vt, per_group)``, each entry ``(gram [CF·S, CF·S], evals,
    evecs, V_t_g [CF·S, N_grad])``.  The eigenpairs: the full ascending
    decomposition (``eig_backend`` ``"xla"`` or ``"dc"``); with ``k_top``
    the top-``k_top`` by ``solver`` (``"eigh"``, ``"lobpcg"``, ``"dc"``);
    ``None`` with ``compute_eigh=False``.  ``deflate_ce_null`` (exact CE)
    solves on the Gram-level deflated Gram and lifts the vectors; the full
    Gram is still returned (λ needs it).  ``X``, ``y`` lie on the
    parameters' device.
    """
    from vivit_tpu_torch.eig import full_eigh, topk_eigh
    from vivit_tpu_torch.engines import build_vt, gram_any, resolve_model, vt_mat_prod_any
    from vivit_tpu_torch.ggn import _subsample, batch_grad
    from vivit_tpu_torch.precision import _PRECISIONS, matmul_precision

    if loss.reduction != "mean":
        raise ValueError(
            "Directional derivatives require reduction='mean' "
            "(same restriction as the reference)."
        )
    model_fn, fwd_params = resolve_model(model, params)
    N = batch_size if batch_size is not None else X.shape[0]
    with matmul_precision(precision):
        vt = build_vt(model, loss, params, X, y, subsampling=subsampling_ggn,
                      mc_samples=mc_samples_ggn, key=key, batch_size=N, engine=engine,
                      conv_vt_dtype=conv_vt_dtype)
        grads = batch_grad(model, loss, X, y, params=params,
                           subsampling=subsampling_grad, batch_size=N)
        # undo the 1/N BatchGrad convention: unscaled per-sample gradients ∇ℓ_n
        grads = {name: g * N for name, g in grads.items()}

        probs = None
        if deflate_ce_null:
            from vivit_tpu_torch.deflate import ce_probs, check_deflatable

            check_deflatable(loss, mc_samples_ggn)
            probs = ce_probs(model_fn, _subsample(X, y, subsampling_ggn)[0], fwd_params)

        per_group = []
        for paths in group_paths:
            gram = gram_any(vt, paths, precision=_PRECISIONS[gram_precision])
            if compute_eigh and k_top is not None:
                if probs is not None:
                    from vivit_tpu_torch.deflate import deflated_topk_eigh

                    evals, evecs = deflated_topk_eigh(gram, probs, k_top, solver=solver,
                                                      lobpcg_iters=lobpcg_iters)
                else:
                    evals, evecs = topk_eigh(gram, k_top, solver=solver,
                                             lobpcg_iters=lobpcg_iters)
            elif compute_eigh and probs is not None:
                from vivit_tpu_torch.deflate import deflated_eigh

                evals, evecs = deflated_eigh(gram, probs, backend=eig_backend)
            elif compute_eigh:
                evals, evecs = full_eigh(gram, backend=eig_backend)
            else:
                evals, evecs = None, None
            v_t_g = vt_mat_prod_any(vt, [grads[p] for p in paths], paths)
            per_group.append((gram, evals, evecs, v_t_g))
    return vt, tuple(per_group)


def gammas_lambdas(
    gram: torch.Tensor,
    evals_sel: torch.Tensor,
    evecs_sel: torch.Tensor,
    v_t_g: torch.Tensor,
    s_ggn: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2: directional derivatives from Gram-space quantities.

    ``gram [CF·S, CF·S]``, the selected ``evals_sel [K]`` and Gram
    eigenvectors ``evecs_sel [CF·S, K]``, the projections ``v_t_g [CF·S,
    N_grad]`` and the number of GGN samples ``s_ggn`` → ``gammas [N_grad,
    K]``, ``lambdas [S, K]``.
    """
    inv_sqrt = 1.0 / torch.sqrt(evals_sel)
    gammas = torch.einsum("in,ik->nk", v_t_g, evecs_sel) * inv_sqrt[None, :]
    cfs = gram.shape[0]
    gram4 = gram.reshape(cfs // s_ggn, s_ggn, cfs)
    g_ne = torch.einsum("cni,ik->cnk", gram4, evecs_sel)
    lambdas = s_ggn * torch.sum(g_ne ** 2, dim=0) / evals_sel[None, :]
    return gammas, lambdas


def topk_entry(name, finish, model, loss, X, y, k, *, params, paths, subsampling_grad,
               subsampling_ggn, mc_samples_ggn, key, batch_size, precision,
               gram_precision, solver, lobpcg_iters, deflate_ce_null, engine,
               device, conv_vt_dtype=None, **settings):
    """The entry point ``name`` over the top-``k`` half shared by
    :func:`~vivit_tpu_torch.optim.newton_step_topk` and
    :func:`~vivit_tpu_torch.optim.directional_derivatives_topk`: stage 1
    without eigensolve, the (optionally deflated) top-``k`` and γ/λ, then
    ``finish(vt, paths, evals_sel, evecs_sel, gammas, lambdas)``, the
    entry's result.  On the card the call is captured as CUDA graphs and
    replayed by key (:func:`vivit_tpu_torch.engines.entry`; ``settings``
    are the rest of the key, e.g. the damping).
    """
    from vivit_tpu_torch.eig import topk_eigh
    from vivit_tpu_torch.engines import entry, resolve_model
    from vivit_tpu_torch.ggn import _subsample
    from vivit_tpu_torch.precision import matmul_precision
    from vivit_tpu_torch.utils.device import inputs_on

    model_fn, fwd_params = resolve_model(model, params)
    if deflate_ce_null:
        from vivit_tpu_torch.deflate import check_deflatable

        check_deflatable(loss, mc_samples_ggn)
    X, y = inputs_on(model, X, y, device, params=params)
    paths = list(fwd_params) if paths is None else list(paths)
    n = batch_size if batch_size is not None else X.shape[0]
    s_ggn = len(subsampling_ggn) if subsampling_ggn is not None else n

    def body(X, y, params):
        vt, ((gram, _, _, v_t_g),) = derivatives_stage1(
            model, loss, X, y, params=params, group_paths=(tuple(paths),),
            subsampling_grad=subsampling_grad, subsampling_ggn=subsampling_ggn,
            mc_samples_ggn=mc_samples_ggn, key=key, batch_size=batch_size,
            precision=precision, gram_precision=gram_precision, compute_eigh=False,
            engine=engine, conv_vt_dtype=conv_vt_dtype,
        )
        with matmul_precision(precision):
            if deflate_ce_null:
                from vivit_tpu_torch.deflate import ce_probs, deflated_topk_eigh

                probs = ce_probs(model_fn, _subsample(X, y, subsampling_ggn)[0],
                                 fwd_params if params is None else params)
                evals_sel, evecs_sel = deflated_topk_eigh(
                    gram, probs, k, solver=solver, lobpcg_iters=lobpcg_iters)
            else:
                evals_sel, evecs_sel = topk_eigh(gram, k, solver=solver,
                                                 lobpcg_iters=lobpcg_iters)
            gammas, lambdas = gammas_lambdas(gram, evals_sel, evecs_sel, v_t_g, s_ggn)
            return finish(vt, paths, evals_sel, evecs_sel, gammas, lambdas)

    return entry(name, body, model, params, X, y, loss, mc_samples_ggn, solver,
                 subsampling_ggn, deflate_ce_null, k=k, paths=paths,
                 subsampling_grad=subsampling_grad, batch_size=batch_size,
                 precision=precision, gram_precision=gram_precision,
                 lobpcg_iters=lobpcg_iters, engine=engine, conv_vt_dtype=conv_vt_dtype,
                 **settings)
