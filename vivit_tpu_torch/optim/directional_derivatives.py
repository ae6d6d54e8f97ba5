"""First- and second-order directional derivatives along GGN eigenvectors
(counterpart of ``vivit_tpu/optim/directional_derivatives.py``).  The math
and scaling conventions are in :mod:`vivit_tpu_torch.optim.utils`.
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
from vivit_tpu_torch.optim.utils import (
    derivatives_stage1,
    gammas_lambdas,
    topk_derivatives,
)
from vivit_tpu_torch.utils.checks import check_subsampling_unique


def directional_derivatives_topk(
    model,
    loss: Loss,
    X,
    y,
    k: int,
    *,
    params: Optional[Dict[str, torch.Tensor]] = None,
    paths: Optional[Sequence[str]] = None,
    subsampling_grad: Optional[Sequence[int]] = None,
    subsampling_ggn: Optional[Sequence[int]] = None,
    mc_samples_ggn: int = 0,
    key: Optional[int] = None,
    batch_size: Optional[int] = None,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    solver: str = "eigh",
    deflate_ce_null: bool = False,
    engine: str = "tapped",
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(evals [k] ascending, γ [N_grad, k], λ [S_ggn, k])`` along the
    top-``k`` GGN directions of the parameters ``paths`` (default: all).

    The model forms and knobs as in
    :func:`~vivit_tpu_torch.optim.newton_step_topk`.  As in the JAX
    package, there is no ``lobpcg_iters``: ``solver="lobpcg"`` runs its
    default 100 iterations at most.  ``device`` defaults to the CUDA card.
    """
    _, _, evals_sel, _, gammas, lambdas = topk_derivatives(
        model, loss, X, y, k, params=params, paths=paths,
        subsampling_grad=subsampling_grad, subsampling_ggn=subsampling_ggn,
        mc_samples_ggn=mc_samples_ggn, key=key, batch_size=batch_size,
        precision=precision, gram_precision=gram_precision, solver=solver,
        lobpcg_iters=100, deflate_ce_null=deflate_ce_null, engine=engine,
        device=device)
    return evals_sel, gammas, lambdas


class DirectionalDerivativesComputation:
    """γ/λ along GGN eigenvectors per parameter group.

    The model is an ``nn.Module`` or a model function; ``compute`` takes
    ``params=`` (required for a model function) and ``key=`` as
    :class:`~vivit_tpu_torch.linalg.eigvalsh.EigvalshComputation` does.
    ``param_groups`` entries carry ``"params"`` (parameter names) and
    ``"criterion"``.  Result per group: ``(gammas [N_grad, K], lambdas
    [S_ggn, K])`` with ``γ[n, k] = g_nᵀ e_k`` and ``λ[n, k] = e_kᵀ (J_nᵀ H_n
    J_n) e_k``.  ``device`` defaults to the CUDA card.
    """

    def __init__(
        self,
        model,
        loss: Loss,
        subsampling_grad: Optional[Sequence[int]] = None,
        subsampling_ggn: Optional[Sequence[int]] = None,
        mc_samples_ggn: int = 0,
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
        check_subsampling_unique(subsampling_grad)
        check_subsampling_unique(subsampling_ggn)
        if deflate_ce_null:
            from vivit_tpu_torch.deflate import check_deflatable

            check_deflatable(loss, mc_samples_ggn)
        self._model = model
        self._loss = loss
        self._stage1 = dict(
            subsampling_grad=subsampling_grad, subsampling_ggn=subsampling_ggn,
            mc_samples_ggn=mc_samples_ggn, precision=precision,
            gram_precision=gram_precision, eig_backend=eig_backend,
            deflate_ce_null=deflate_ce_null, engine=engine, conv_vt_dtype=conv_vt_dtype)
        self._subsampling_ggn = subsampling_ggn
        self._self_check = self_check
        self._self_checked = False
        self._verbose = verbose
        self._warn_small_eigvals = warn_small_eigvals
        self._precision = precision
        self._device = device
        self._gammas: Dict[tuple, torch.Tensor] = {}
        self._lambdas: Dict[tuple, torch.Tensor] = {}

    def compute(self, X, y, param_groups: List[Dict], *,
                params: Optional[Dict[str, torch.Tensor]] = None,
                key: Optional[int] = None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Run the computation on the batch ``(X, y)``; returns ``(gammas,
        lambdas)`` per group."""
        from vivit_tpu_torch.precision import matmul_precision

        X, y, diff_params = start_compute(self, X, y, params)
        param_groups = resolve_param_groups(
            diff_params, param_groups, required_keys=("params", "criterion"))
        group_paths = tuple(tuple(g["params"]) for g in param_groups)
        if self._verbose:
            print(f"DirectionalDerivativesComputation: groups {group_paths}")
        s_ggn = (len(self._subsampling_ggn) if self._subsampling_ggn is not None
                 else X.shape[0])
        _, per_group = derivatives_stage1(self._model, self._loss, X, y, params=params,
                                          group_paths=group_paths, key=key,
                                          **self._stage1)

        results = []
        with matmul_precision(self._precision):
            for group, (gram, evals, evecs, v_t_g) in zip(param_groups, per_group):
                keep = kept_indices(group["criterion"], evals)
                evals_sel, evecs_sel = evals[keep], evecs[:, keep]
                warn_if_small(evals_sel, self._warn_small_eigvals)
                gammas, lambdas = gammas_lambdas(gram, evals_sel, evecs_sel, v_t_g,
                                                 s_ggn)
                self._gammas[group_key(group)] = gammas
                self._lambdas[group_key(group)] = lambdas
                results.append((gammas, lambdas))
        return results

    def get_result(self, group: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(gammas, lambdas)`` of ``group`` from the last :meth:`compute`."""
        key = group_key(group)
        try:
            return self._gammas[key], self._lambdas[key]
        except KeyError as e:
            raise KeyError("No results available for this group") from e
