r"""Directionally damped Newton steps in the GGN eigenbasis (counterpart of
``vivit_tpu/optim/directional_damped_newton.py``).

The step along the ``K`` kept directions is

.. math::
    s = \sum_{k=1}^K \frac{-\bar\gamma_k}{\bar\lambda_k + \delta_k} e_k,

with :math:`\bar\gamma_k, \bar\lambda_k` the sample means of the directional
derivatives and :math:`\delta_k` the damping of direction ``k``.
"""

from typing import Dict, List, Optional, Sequence

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
    topk_entry,
)
from vivit_tpu_torch.utils.checks import check_subsampling_unique


def constant_damping(value: float = 1.0):
    """Damping callable: ``δ_k = value`` for every direction.  Its
    ``graph_key`` keys a captured call by ``value``
    (the entry points' cache key, :mod:`vivit_tpu_torch.engines`)."""

    def damping(evals, evecs, gammas, lambdas):
        return value * torch.ones_like(evals)

    damping.graph_key = ("constant_damping", value)
    return damping


def newton_step_from_derivatives(
    vt,
    paths: Sequence[str],
    evals_sel: torch.Tensor,
    evecs_sel: torch.Tensor,
    gammas: torch.Tensor,
    lambdas: torch.Tensor,
    dampings,
) -> List[torch.Tensor]:
    """Weight the directions in Gram space and back-project the step through
    ``V``: one ``[*param.shape]`` tensor per name in ``paths``.  ``dampings``
    is ``[K]`` or a scalar."""
    from vivit_tpu_torch.engines import v_mat_prod_any

    coefficients = (-gammas.mean(dim=0) / (lambdas.mean(dim=0) + dampings)
                    / torch.sqrt(evals_sel))
    v = evecs_sel @ coefficients  # the Gram-space step [CF·S]
    return [leaf[0] for leaf in v_mat_prod_any(vt, v[None, :], paths)]


def newton_step_topk(
    model,
    loss: Loss,
    X,
    y,
    k: int,
    damping=1.0,
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
    lobpcg_iters: int = 100,
    deflate_ce_null: bool = False,
    engine: str = "tapped",
    conv_vt_dtype: Optional[torch.dtype] = None,
    device=None,
) -> List[torch.Tensor]:
    """Damped Newton step along the top-``k`` GGN directions of the
    parameters ``paths`` (default: all, in order), one tensor per name.

    ``model`` is an ``nn.Module`` (``engine`` ``"tapped"`` or ``"vjp"``) or
    a model function with ``params=``.  ``damping`` is a scalar or a
    callable ``(evals, gram_evecs, gammas, lambdas) -> δ [k]``; ``solver``
    ``"eigh"``, ``"lobpcg"`` or ``"dc"``; ``deflate_ce_null`` (exact CE)
    runs the top-``k`` on the Gram-level deflated Gram;
    ``mc_samples_ggn``/``key`` select Monte-Carlo GGN factors;
    ``conv_vt_dtype`` stores a module's conv blocks demoted.  ``device``
    defaults to the CUDA card, where the call is captured as CUDA graphs
    and replayed by key (:func:`vivit_tpu_torch.utils.graphs.stage`): a
    ``damping`` callable runs inside the capture and must not read the
    host.
    """
    def finish(vt, paths, evals_sel, evecs_sel, gammas, lambdas):
        if callable(damping):
            dampings = damping(evals_sel, evecs_sel, gammas, lambdas)
        else:
            dampings = damping * torch.ones_like(evals_sel)
        return newton_step_from_derivatives(vt, paths, evals_sel, evecs_sel, gammas,
                                            lambdas, dampings)

    return topk_entry(
        "newton_step_topk", finish, model, loss, X, y, k, params=params, paths=paths,
        subsampling_grad=subsampling_grad, subsampling_ggn=subsampling_ggn,
        mc_samples_ggn=mc_samples_ggn, key=key, batch_size=batch_size,
        precision=precision, gram_precision=gram_precision, solver=solver,
        lobpcg_iters=lobpcg_iters, deflate_ce_null=deflate_ce_null, engine=engine,
        device=device, conv_vt_dtype=conv_vt_dtype, damping=damping)


class DirectionalDampedNewtonComputation:
    """Damped Newton steps per parameter group.

    The model is an ``nn.Module`` or a model function; ``compute`` takes
    ``params=`` (required for a model function) and ``key=`` as
    :class:`~vivit_tpu_torch.linalg.eigvalsh.EigvalshComputation` does.
    ``param_groups`` entries carry ``"params"`` (parameter names),
    ``"criterion"`` (ascending eigenvalues as numpy → indices to keep) and
    ``"damping"`` (``(evals, evecs, gammas, lambdas) -> δ [K]``).  The
    result per group is the Newton step, one tensor per name in the group's
    order.  ``solver``/``k_top`` replace the full Gram eigendecomposition by
    a top-``k_top`` solve (``"eigh"``, ``"lobpcg"``, ``"dc"``); the
    criterion then sees only those ``k_top`` eigenvalues.  ``self_check``
    runs :func:`vivit_tpu_torch.utils.checks.check_model_fn` on the first
    ``compute``.  ``device`` defaults to the CUDA card, where ``compute``
    runs the V-transform and each group's Gram solve as one captured
    program (:func:`vivit_tpu_torch.engines.stage`); the criteria,
    dampings and steps run eagerly after it.
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
        solver: str = "eigh",
        k_top: Optional[int] = None,
        lobpcg_iters: int = 100,
        self_check: bool = False,
        device=None,
    ):
        check_subsampling_unique(subsampling_grad)
        check_subsampling_unique(subsampling_ggn)
        if deflate_ce_null:
            from vivit_tpu_torch.deflate import check_deflatable

            check_deflatable(loss, mc_samples_ggn)
        if k_top is None and solver != "eigh":
            raise ValueError(
                "solver != 'eigh' requires k_top (iterative solvers "
                "compute a top-k eigenbasis, not the full spectrum)."
            )
        self._model = model
        self._loss = loss
        self._stage1 = dict(
            subsampling_grad=subsampling_grad, subsampling_ggn=subsampling_ggn,
            mc_samples_ggn=mc_samples_ggn, precision=precision,
            gram_precision=gram_precision, eig_backend=eig_backend,
            deflate_ce_null=deflate_ce_null, engine=engine, conv_vt_dtype=conv_vt_dtype,
            solver=solver, k_top=k_top, lobpcg_iters=lobpcg_iters)
        self._subsampling_ggn = subsampling_ggn
        self._self_check = self_check
        self._self_checked = False
        self._verbose = verbose
        self._warn_small_eigvals = warn_small_eigvals
        self._precision = precision
        self._device = device
        self._newton_steps: Dict[tuple, List[torch.Tensor]] = {}

    def compute(self, X, y, param_groups: List[Dict], *,
                params: Optional[Dict[str, torch.Tensor]] = None,
                key: Optional[int] = None) -> List[List[torch.Tensor]]:
        """Run the computation on the batch ``(X, y)``; returns the Newton
        step per group."""
        from vivit_tpu_torch.engines import stage
        from vivit_tpu_torch.precision import matmul_precision

        X, y, diff_params = start_compute(self, X, y, params)
        param_groups = resolve_param_groups(
            diff_params, param_groups, required_keys=("params", "criterion", "damping"))
        group_paths = tuple(tuple(g["params"]) for g in param_groups)
        if self._verbose:
            print(f"DirectionalDampedNewtonComputation: groups {group_paths}")
        s_ggn = (len(self._subsampling_ggn) if self._subsampling_ggn is not None
                 else X.shape[0])
        s = self._stage1
        (vt, per_group), _ = stage(
            "DirectionalDampedNewtonComputation", lambda X, y, params: derivatives_stage1(
                self._model, self._loss, X, y, params=params, group_paths=group_paths,
                key=key, **s),
            self._model, params, X, y, self._loss, s["mc_samples_ggn"],
            s["solver"] if s["k_top"] is not None else s["eig_backend"],
            s["subsampling_ggn"], s["deflate_ce_null"], groups=group_paths, **s)

        results = []
        with matmul_precision(self._precision):
            for group, paths, (gram, evals, evecs, v_t_g) in zip(
                    param_groups, group_paths, per_group):
                keep = kept_indices(group["criterion"], evals)
                evals_sel, evecs_sel = evals[keep], evecs[:, keep]
                warn_if_small(evals_sel, self._warn_small_eigvals)
                gammas, lambdas = gammas_lambdas(gram, evals_sel, evecs_sel, v_t_g,
                                                 s_ggn)
                dampings = group["damping"](evals_sel, evecs_sel, gammas, lambdas)
                step = newton_step_from_derivatives(vt, paths, evals_sel, evecs_sel,
                                                    gammas, lambdas, dampings)
                self._newton_steps[group_key(group)] = step
                results.append(step)
        return results

    def get_result(self, group: Dict) -> List[torch.Tensor]:
        """The Newton step of ``group`` from the last :meth:`compute`."""
        try:
            return self._newton_steps[group_key(group)]
        except KeyError as e:
            raise KeyError("No results available for this group") from e

