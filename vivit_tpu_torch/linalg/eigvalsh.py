"""GGN block eigenvalues through the ``CF·S`` Gram (counterpart of
``vivit_tpu/linalg/eigvalsh.py``).

Semantics of the reference: all ``CF·S`` eigenvalues of each group's Gram
``G̃ = Vᵀ V``, ascending, unfiltered; the sub-sampling rescale ``N/|S|``
folded into ``V``; Monte-Carlo factors with ``mc_samples``.

The model is an ``nn.Module`` (the structured engine, factor-level CE
deflation: :func:`vivit_tpu_torch.structured.eigvalsh_structured`) or a
model function ``model_fn(params, X)`` with ``params=`` (the generic engine,
CE deflation at the Gram level: :func:`vivit_tpu_torch.deflate.deflated_eigvalsh`).
"""

from typing import Dict, List, Optional, Sequence

import torch

from vivit_tpu_torch.linalg.utils import group_key, resolve_param_groups, start_compute
from vivit_tpu_torch.losses import Loss
from vivit_tpu_torch.utils.checks import check_subsampling_unique


def eigvalsh(
    model,
    loss: Loss,
    X,
    y,
    *,
    params: Optional[Dict[str, torch.Tensor]] = None,
    group_paths: Optional[Sequence[Sequence[str]]] = None,
    subsampling: Optional[Sequence[int]] = None,
    mc_samples: int = 0,
    key: Optional[int] = None,
    batch_size: Optional[int] = None,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    eig_backend: str = "xla",
    deflate_ce_null: bool = False,
    engine: str = "tapped",
    conv_vt_dtype: Optional[torch.dtype] = None,
    device=None,
):
    """Tuple of ascending eigenvalue tensors, one per group of parameter
    names (default: one group of all parameters).

    ``precision`` applies to the whole pipeline (``"highest"``: full f32,
    TF32 off); ``gram_precision`` demotes the materialized Gram operands
    (``"bf16"``).  ``deflate_ce_null`` (exact CE) solves the ``(C−1)·S``
    deflated Gram and returns the ``S`` structural zeros exactly.
    ``device`` defaults to the CUDA card; the parameters must lie there.
    ``engine``, ``conv_vt_dtype`` and the ``batch_size`` default apply to a
    module, ``params`` and ``batch_size`` to a model function.  On the card
    the call is captured as CUDA graphs and replayed by key
    (:func:`vivit_tpu_torch.utils.graphs.stage`).
    """
    from vivit_tpu_torch.engines import is_module, resolve_model

    model_fn, fwd_params = resolve_model(model, params)
    if is_module(model):
        from vivit_tpu_torch.structured import eigvalsh_structured

        return eigvalsh_structured(
            model, loss, X, y, group_paths=group_paths, subsampling=subsampling,
            mc_samples=mc_samples, key=key, precision=precision,
            gram_precision=gram_precision, eig_backend=eig_backend,
            deflate_ce_null=deflate_ce_null, engine=engine,
            conv_vt_dtype=conv_vt_dtype, device=device)

    from vivit_tpu_torch.deflate import ce_probs, check_deflatable, deflated_eigvalsh
    from vivit_tpu_torch.eig import full_eigh
    from vivit_tpu_torch.ggn import _subsample, ggn_sqrt_vt
    from vivit_tpu_torch.gram import gram_matrix
    from vivit_tpu_torch.precision import _PRECISIONS, matmul_precision
    from vivit_tpu_torch.utils import graphs
    from vivit_tpu_torch.utils.device import inputs_on

    params = fwd_params
    if deflate_ce_null:
        check_deflatable(loss, mc_samples)
    X, y = inputs_on(model, X, y, device, params=params)
    if group_paths is None:
        group_paths = (tuple(params),)
    group_paths = tuple(tuple(paths) for paths in group_paths)

    def body(X, y, params):
        with matmul_precision(precision):
            vt = ggn_sqrt_vt(model_fn, loss, params, X, y, subsampling=subsampling,
                             mc_samples=mc_samples, key=key, batch_size=batch_size)
            probs = None
            if deflate_ce_null:
                probs = ce_probs(model_fn, _subsample(X, y, subsampling)[0], params)
            evals = []
            for paths in group_paths:
                gram = gram_matrix(vt, paths=paths, precision=_PRECISIONS[gram_precision])
                if probs is not None:
                    evals.append(deflated_eigvalsh(gram, probs, backend=eig_backend))
                else:
                    evals.append(full_eigh(gram, backend=eig_backend, eigenvectors=False)[0])
        return tuple(evals)

    cache_key = graphs.entry_key(
        "eigvalsh", model, params, X, y, loss, group_paths=group_paths,
        subsampling=subsampling, mc_samples=mc_samples, batch_size=batch_size,
        precision=precision, gram_precision=gram_precision, eig_backend=eig_backend,
        deflate_ce_null=deflate_ce_null)
    return graphs.entry(cache_key, body, X, y, params, lambda: graphs.captured(
        X, mc_samples, eig_backend,
        lambda: graphs.gram_side(model_fn, params, X, subsampling, deflate_ce_null)))


class EigvalshComputation:
    """GGN block eigenvalues per parameter group (reference
    ``EigvalshComputation``).

    Example::

        comp = EigvalshComputation(model_fn, CrossEntropyLoss())
        evals = comp.compute(X, y, param_groups, params=params)  # one per group
        comp.get_result(param_groups[0])

    ``model`` is an ``nn.Module`` (then ``compute`` takes no ``params``) or
    a model function ``model_fn(params, X)`` (then ``compute`` needs
    ``params=``, a ``{name: Tensor}`` dict on the device).  Groups carry
    ``"params"``, lists of parameter names; ``param_groups=None`` is one
    group of all.  ``key`` (an int) seeds the Monte-Carlo draws.
    ``self_check`` runs :func:`vivit_tpu_torch.utils.checks.check_model_fn`
    on the first ``compute``.  ``device`` defaults to the CUDA card, where
    ``compute`` replays the captured :func:`eigvalsh` (or
    :func:`~vivit_tpu_torch.structured.eigvalsh_structured` for a module).
    """

    def __init__(
        self,
        model,
        loss: Loss,
        subsampling: Optional[Sequence[int]] = None,
        mc_samples: int = 0,
        verbose: bool = False,
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
        self._settings = dict(
            subsampling=None if subsampling is None else tuple(subsampling),
            mc_samples=mc_samples, precision=precision, gram_precision=gram_precision,
            eig_backend=eig_backend, deflate_ce_null=deflate_ce_null, engine=engine,
            conv_vt_dtype=conv_vt_dtype, device=device)
        self._verbose = verbose
        self._self_check = self_check
        self._self_checked = False
        self._device = device
        self._evals: Dict[tuple, torch.Tensor] = {}

    def compute(self, X, y, param_groups: Optional[List[Dict]] = None, *,
                params: Optional[Dict[str, torch.Tensor]] = None,
                key: Optional[int] = None) -> List[torch.Tensor]:
        """Run the computation on the batch ``(X, y)``; returns the
        eigenvalues per group, ascending."""
        X, y, diff_params = start_compute(self, X, y, params)
        param_groups = resolve_param_groups(diff_params, param_groups)
        group_paths = tuple(tuple(g["params"]) for g in param_groups)
        if self._verbose:
            print(f"EigvalshComputation: groups {group_paths}")
        results = eigvalsh(self._model, self._loss, X, y, params=params,
                           group_paths=group_paths, key=key, **self._settings)
        for group, evals in zip(param_groups, results):
            self._evals[group_key(group)] = evals
        return list(results)

    def get_result(self, group: Dict) -> torch.Tensor:
        """The eigenvalues of ``group`` from the last :meth:`compute`."""
        try:
            return self._evals[group_key(group)]
        except KeyError as e:
            raise KeyError("No results available for this group") from e
