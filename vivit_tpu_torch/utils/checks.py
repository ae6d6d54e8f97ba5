"""Input validation (counterpart of ``vivit_tpu/utils/checks.py``)."""

from typing import Dict, List, Optional, Sequence


def check_subsampling_unique(subsampling: Optional[Sequence[int]]) -> None:
    """Raise ``ValueError`` if sub-sampling indices contain duplicates."""
    if subsampling is not None:
        if len(set(subsampling)) != len(subsampling):
            raise ValueError(f"Subsampling indices must be unique. Got {subsampling}.")


def check_key_exists(param_groups: List[Dict], key: str) -> None:
    """Raise ``ValueError`` if any group misses ``key``."""
    for group in param_groups:
        if key not in group.keys():
            raise ValueError(f"Group {group} does not specify '{key}'.")


def check_unique_params(param_groups: List[Dict]) -> None:
    """Raise ``ValueError`` if a parameter name occurs in more than one group."""
    seen = set()
    for group in param_groups:
        for name in group["params"]:
            if name in seen:
                raise ValueError(f"Parameter '{name}' occurs in more than one group.")
            seen.add(name)


def check_params_exist(param_groups: List[Dict], params) -> None:
    """Raise ``ValueError`` if a group names a parameter not in ``params``
    (a parameter dict or a sequence of names)."""
    available = set(params)
    for group in param_groups:
        missing = [p for p in group["params"] if p not in available]
        if missing:
            raise ValueError(
                f"Group references unknown parameter paths {missing}. "
                f"Available: {sorted(available)}"
            )


def check_model_fn(model_fn, params, X, rtol: float = 5e-5, atol: float = 1e-6) -> None:
    """Opt-in guard: the V-transform's forward must be deterministic and
    per-sample separable (counterpart of the JAX package's
    ``check_model_fn``, same tolerances).

    The generic V-transform takes each sample's vjp as that sample's GGN
    factor, which holds only if ``model_fn(params, X)[n]`` depends on sample
    ``n`` alone, and two evaluations must agree (train-mode Dropout makes
    the factors ill-defined).  Raises ``RuntimeError`` on a violation: two
    forwards that disagree, or sample 0 or ``N−1`` alone giving another
    output than in the batch (train-mode BatchNorm; a forward that cannot
    run on one sample fails the same way).
    """
    import torch

    with torch.no_grad():
        f1 = model_fn(params, X)
        f2 = model_fn(params, X)
        if not torch.allclose(f1, f2, rtol=rtol, atol=atol):
            raise RuntimeError(
                "Check for deterministic model failed: two forward evaluations "
                f"disagree (max dev {(f1 - f2).abs().max().item():.2e}). "
                "Stochastic layers (train-mode Dropout) make the GGN factors "
                "ill-defined: evaluate the model deterministically (eval mode)."
            )
        separability = (
            "Per-sample separability check failed: f(params, X)[n] != "
            "f(params, X[n:n+1])[0] ({}). Batch-coupled layers (train-mode "
            "BatchNorm, batch-shaped Dropout masks) break the per-sample "
            "Jacobian the GGN factorization needs: use eval mode."
        )
        n = X.shape[0]
        for i in (0, n - 1):
            try:
                fi = model_fn(params, X[i:i + 1])[0]
            except (RuntimeError, ValueError) as e:
                raise RuntimeError(separability.format(
                    f"sample {i} alone does not run: {e}")) from e
            if not torch.allclose(fi, f1[i], rtol=rtol, atol=atol):
                raise RuntimeError(separability.format(
                    f"max dev {(fi - f1[i]).abs().max().item():.2e} at sample {i}"))
