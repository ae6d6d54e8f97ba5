"""Parameter groups and eigenvalue criteria of the computation classes
(counterpart of ``vivit_tpu/linalg/utils.py``).

Parameters are named as ``module.named_parameters()`` names them; a group's
``"params"`` is a list of such names.
"""

import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from vivit_tpu_torch.utils.checks import (
    check_key_exists,
    check_params_exist,
    check_unique_params,
)

SMALL_EIGVALS_WARNING = (
    "Some eigenvalues are small. Computations that divide by their square root"
    " (eigenvector transformation into parameter space, directional gradients)"
    " are numerically unstable."
    " Maybe use a more restrictive eigenvalue filter criterion."
)


def resolve_param_groups(
    names: Sequence[str],
    param_groups: Optional[List[Dict]],
    required_keys: Sequence[str] = ("params",),
) -> List[Dict]:
    """Normalize and validate ``param_groups`` over the parameter ``names``.

    ``None`` becomes one group of every name (with :func:`keep_all` where a
    ``"criterion"`` is required; a required ``"damping"`` has no default).
    Then: required keys present, names known, no name in two groups.
    """
    if param_groups is None:
        param_groups = [{"params": list(names)}]
        if "criterion" in required_keys:
            param_groups[0]["criterion"] = keep_all
        if "damping" in required_keys:
            raise ValueError("param_groups with a 'damping' entry are required.")
    for key in required_keys:
        check_key_exists(param_groups, key)
    check_unique_params(param_groups)
    check_params_exist(param_groups, names)
    return param_groups


def group_key(group: Dict) -> tuple:
    """Result key of a parameter group: its tuple of names (by content, not
    ``id``, so a freed dict's id cannot alias another group's results)."""
    return tuple(group["params"])


def keep_all(evals) -> List[int]:
    """Criterion keeping every direction."""
    return list(range(int(np.asarray(evals).shape[0])))


def keep_top_k(k: int, must_exceed: float = 0.0) -> Callable:
    """Criterion keeping the ``k`` largest (ascending) eigenvalues above
    ``must_exceed``."""

    def criterion(evals) -> List[int]:
        if k <= 0:
            return []
        ev = np.asarray(evals)
        candidates = [i for i in range(ev.shape[0]) if ev[i] > must_exceed]
        return candidates[-k:] if k < len(candidates) else candidates

    return criterion


def keep_nonzero(atol: float = 1e-7, rtol: float = 1e-5) -> Callable:
    """Criterion dropping numerically zero eigenvalues (``np.isclose`` to 0)."""

    def criterion(evals) -> List[int]:
        ev = np.asarray(evals)
        keep = ~np.isclose(ev, 0.0, rtol=rtol, atol=atol)
        return [i for i in range(ev.shape[0]) if keep[i]]

    return criterion


def kept_indices(criterion, evals: torch.Tensor) -> torch.Tensor:
    """The indices ``criterion`` keeps of the ascending ``evals`` (handed to
    it as numpy), as a tensor on their device."""
    keep = np.asarray(criterion(evals.cpu().numpy()), dtype=np.int64)
    return torch.as_tensor(keep, device=evals.device)


def start_compute(comp, X, y, params):
    """The common start of the computation classes' ``compute``: the
    model's parameters (``params``, required for a model function, or the
    module's own), ``(X, y)`` on the class's device after checking that the
    parameters lie there, and the opt-in ``self_check``
    (:func:`vivit_tpu_torch.utils.checks.check_model_fn`) on the first call.
    ``comp`` carries ``_model``, ``_device``, ``_self_check`` and
    ``_self_checked``.  Returns ``(X, y, params)``."""
    from vivit_tpu_torch.engines import resolve_model
    from vivit_tpu_torch.utils.device import inputs_on

    model_fn, diff_params = resolve_model(comp._model, params)
    X, y = inputs_on(comp._model, X, y, comp._device, params=params)
    if comp._self_check and not comp._self_checked:
        from vivit_tpu_torch.utils.checks import check_model_fn

        check_model_fn(model_fn, diff_params, X)
        comp._self_checked = True
    return X, y, diff_params


def warn_if_small(evals: torch.Tensor, threshold: float) -> None:
    """Warn if an eigenvalue's magnitude is below ``threshold`` (one host
    read)."""
    if threshold and bool((evals.abs() < threshold).any()):
        warnings.warn(SMALL_EIGVALS_WARNING)
