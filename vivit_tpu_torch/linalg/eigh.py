"""GGN block eigenpairs with parameter-space back-projection (counterpart
of ``vivit_tpu/linalg/eigh.py``).

``Vᵀ`` transform (undeflated; the structured engine for an ``nn.Module``,
the generic one for a model function) → Gram ``G̃`` → eigenpairs,
optionally through the Gram-level CE deflation (the ``S`` structural zeros
come back with their analytic eigenvectors) → ``e = V ẽ``, normalized over
the group's parameters.  :class:`EighComputation` selects directions with a
host-side ``criterion`` on the full spectrum; :func:`eigh_topk` takes a
fixed top-``k``.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from vivit_tpu_torch.linalg.utils import (
    group_key,
    kept_indices,
    resolve_param_groups,
    start_compute,
    warn_if_small,
)
from vivit_tpu_torch.losses import Loss
from vivit_tpu_torch.utils.checks import check_subsampling_unique


def backproject(vt, gram_evecs: torch.Tensor, gram_evals: torch.Tensor,
                paths: Sequence[str]) -> List[torch.Tensor]:
    """Normalized parameter-space eigenvectors from Gram eigenvectors
    ``[CF·S, K]``: one ``[K, *param.shape]`` tensor per path, for either
    engine's ``Vᵀ`` dict.

    The global normalization replaces the exact ``1/√λ`` scale, as in the
    JAX package, so ``gram_evals`` is not used.
    """
    del gram_evals
    from vivit_tpu_torch.engines import backproject_any

    return backproject_any(vt, gram_evecs, paths)


def eigh_topk(
    model,
    loss: Loss,
    X,
    y,
    k: int,
    *,
    params: Optional[Dict[str, torch.Tensor]] = None,
    paths: Optional[Sequence[str]] = None,
    subsampling: Optional[Sequence[int]] = None,
    mc_samples: int = 0,
    key: Optional[int] = None,
    batch_size: Optional[int] = None,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    solver: str = "eigh",
    lobpcg_iters: int = 100,
    deflate_ce_null: bool = False,
    engine: str = "tapped",
    conv_vt_dtype: Optional[torch.dtype] = None,
    device=None,
):
    """Top-``k`` GGN eigenpairs of one parameter group: ``(evals [k]
    ascending, evecs)``, ``evecs`` one ``[k, *param.shape]`` tensor per path
    (default: all parameters in order).

    ``model`` is an ``nn.Module`` or a model function with ``params=``.
    ``X`` and ``y`` move to ``device``, which defaults to the CUDA card
    (``device="cpu"`` runs on the CPU); the parameters must already lie
    there.  ``solver`` is ``"eigh"`` (vendor), ``"dc"``
    (:mod:`vivit_tpu_torch.eigdc`, eigenvector mode) or ``"lobpcg"`` (at
    most ``lobpcg_iters`` iterations); ``gram_precision`` demotes the
    materialized Gram contractions (``"bf16"``).  ``deflate_ce_null``
    (exact cross-entropy) solves the top-``k`` on the deflated ``(C−1)·S``
    Gram and lifts the vectors back; it needs ``k ≤ (C−1)·S``.
    ``mc_samples``/``key`` select Monte-Carlo factors; ``engine`` and
    ``conv_vt_dtype`` (the conv blocks' storage dtype) apply to a module.
    """
    from vivit_tpu_torch.deflate import ce_probs, check_deflatable, deflated_topk_eigh
    from vivit_tpu_torch.eig import topk_eigh
    from vivit_tpu_torch.engines import build_vt, gram_any, resolve_model
    from vivit_tpu_torch.ggn import _subsample
    from vivit_tpu_torch.precision import _PRECISIONS, matmul_precision
    from vivit_tpu_torch.utils.device import inputs_on

    model_fn, fwd_params = resolve_model(model, params)
    if deflate_ce_null:
        check_deflatable(loss, mc_samples)
    X, y = inputs_on(model, X, y, device, params=params)
    if paths is None:
        paths = list(fwd_params)

    with matmul_precision(precision):
        vt = build_vt(model, loss, params, X, y, subsampling=subsampling,
                      mc_samples=mc_samples, key=key, batch_size=batch_size,
                      engine=engine, conv_vt_dtype=conv_vt_dtype)
        gram = gram_any(vt, paths, precision=_PRECISIONS[gram_precision])
        if deflate_ce_null:
            probs = ce_probs(model_fn, _subsample(X, y, subsampling)[0], fwd_params)
            evals, evecs = deflated_topk_eigh(gram, probs, k, solver=solver,
                                              lobpcg_iters=lobpcg_iters)
        else:
            evals, evecs = topk_eigh(gram, k, solver=solver, lobpcg_iters=lobpcg_iters)
        return evals, backproject(vt, evecs, evals, paths)


def _gram_eigh_all(model, loss, X, y, *, params, group_paths, subsampling, mc_samples,
                   key, gram_precision, eig_backend, deflate_ce_null, engine,
                   conv_vt_dtype):
    """Stage 1 of :class:`EighComputation`: ``Vᵀ`` and each group's
    ``(evals, evecs, guard info)`` of the (optionally Gram-level deflated)
    Gram.  Factor-level deflation would drop the structural-zero directions
    from ``V``; the Gram level keeps them with their analytic eigenvectors,
    so criteria see every eigenvalue."""
    from vivit_tpu_torch.eig import full_eigh
    from vivit_tpu_torch.engines import build_vt, gram_any, resolve_model
    from vivit_tpu_torch.ggn import _subsample
    from vivit_tpu_torch.precision import _PRECISIONS

    model_fn, fwd_params = resolve_model(model, params)
    vt = build_vt(model, loss, params, X, y, subsampling=subsampling,
                  mc_samples=mc_samples, key=key, engine=engine,
                  conv_vt_dtype=conv_vt_dtype)
    if deflate_ce_null:
        from vivit_tpu_torch.deflate import ce_probs, deflated_eigh

        probs = ce_probs(model_fn, _subsample(X, y, subsampling)[0], fwd_params)

        def solve(gram):
            return deflated_eigh(gram, probs, backend=eig_backend, return_info=True)
    else:
        def solve(gram):
            return full_eigh(gram, backend=eig_backend, return_info=True)

    eigs = tuple(solve(gram_any(vt, paths, precision=_PRECISIONS[gram_precision]))
                 for paths in group_paths)
    return vt, eigs


class EighComputation:
    """GGN block eigenpairs per parameter group (reference
    ``EighComputation``).

    Groups carry ``"params"`` (parameter names) and ``"criterion"``
    (ascending eigenvalues as numpy → the indices to keep, run on the
    host).  The result per group is ``(evals, evecs)``, ``evecs`` one
    ``[K, *param.shape]`` tensor per name in the group's order.
    ``eig_backend="dc"`` solves with :mod:`vivit_tpu_torch.eigdc` and its
    guard (:meth:`get_eig_info`); ``deflate_ce_null`` (exact CE) solves the
    ``(C−1)·S`` Gram-level deflated Gram, the ``S`` structural zeros come
    back exact with their analytic eigenvectors.  The model forms,
    ``compute``'s ``params=``/``key=``, ``self_check`` and ``device`` are
    those of :class:`~vivit_tpu_torch.linalg.eigvalsh.EigvalshComputation`.
    """

    def __init__(
        self,
        model,
        loss: Loss,
        subsampling: Optional[Sequence[int]] = None,
        mc_samples: int = 0,
        verbose: bool = False,
        warn_small_eigvals: float = 1e-4,
        precision: str = "highest",
        gram_precision: Optional[str] = None,
        eig_backend: str = "xla",
        deflate_ce_null: bool = False,
        engine: str = "tapped",
        conv_vt_dtype: Optional[torch.dtype] = None,
        self_check: bool = False,
        device=None,
    ):
        check_subsampling_unique(subsampling)
        if deflate_ce_null:
            from vivit_tpu_torch.deflate import check_deflatable

            check_deflatable(loss, mc_samples)
        self._model = model
        self._loss = loss
        self._stage1 = dict(
            subsampling=None if subsampling is None else tuple(subsampling),
            mc_samples=mc_samples, gram_precision=gram_precision,
            eig_backend=eig_backend, deflate_ce_null=deflate_ce_null, engine=engine,
            conv_vt_dtype=conv_vt_dtype)
        self._verbose = verbose
        self._warn_small_eigvals = warn_small_eigvals
        self._precision = precision
        self._self_check = self_check
        self._self_checked = False
        self._device = device
        self._evals: Dict[tuple, torch.Tensor] = {}
        self._evecs: Dict[tuple, List[torch.Tensor]] = {}
        self._eig_info: Dict[tuple, Dict[str, torch.Tensor]] = {}

    def compute(self, X, y, param_groups: List[Dict], *,
                params: Optional[Dict[str, torch.Tensor]] = None,
                key: Optional[int] = None
                ) -> List[Tuple[torch.Tensor, List[torch.Tensor]]]:
        """Run the computation on the batch ``(X, y)``; returns ``(evals,
        evecs)`` per group."""
        from vivit_tpu_torch.precision import matmul_precision

        X, y, diff_params = start_compute(self, X, y, params)
        param_groups = resolve_param_groups(
            diff_params, param_groups, required_keys=("params", "criterion"))
        group_paths = tuple(tuple(g["params"]) for g in param_groups)
        if self._verbose:
            print(f"EighComputation: groups {group_paths}")

        results = []
        with matmul_precision(self._precision):
            vt, eigs = _gram_eigh_all(self._model, self._loss, X, y, params=params,
                                      group_paths=group_paths, key=key, **self._stage1)
            for group, paths, (gram_evals, gram_evecs, info) in zip(
                    param_groups, group_paths, eigs):
                keep = kept_indices(group["criterion"], gram_evals)
                evals = gram_evals[keep]
                warn_if_small(evals, self._warn_small_eigvals)
                evecs = backproject(vt, gram_evecs[:, keep], evals, paths)
                self._evals[group_key(group)] = evals
                self._evecs[group_key(group)] = evecs
                self._eig_info[group_key(group)] = info
                results.append((evals, evecs))
        return results

    def get_result(self, group: Dict) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``(evals, evecs)`` of ``group`` from the last :meth:`compute`."""
        key = group_key(group)
        try:
            return self._evals[key], self._evecs[key]
        except KeyError as e:
            raise KeyError("No results available for this group") from e

    def get_eig_info(self, group: Dict) -> Dict[str, torch.Tensor]:
        """The eigensolver's guard info of ``group`` from the last
        :meth:`compute`: ``{"tripped", "bound", "orth"}``, nonzero only
        under ``eig_backend="dc"``; ``tripped`` means the dc guard fell back
        to ``torch.linalg.eigh`` (the call paid for both solvers)."""
        try:
            return self._eig_info[group_key(group)]
        except KeyError as e:
            raise KeyError("No results available for this group") from e
