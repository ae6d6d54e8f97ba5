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


def check_params_exist(param_groups: List[Dict], names: Sequence[str]) -> None:
    """Raise ``ValueError`` if a group names a parameter not in ``names``."""
    available = set(names)
    for group in param_groups:
        missing = [p for p in group["params"] if p not in available]
        if missing:
            raise ValueError(
                f"Group references unknown parameter paths {missing}. "
                f"Available: {sorted(available)}"
            )
