"""Input validation (counterpart of ``vivit_tpu/utils/checks.py``)."""

from typing import Optional, Sequence


def check_subsampling_unique(subsampling: Optional[Sequence[int]]) -> None:
    """Raise ``ValueError`` if sub-sampling indices contain duplicates."""
    if subsampling is not None:
        if len(set(subsampling)) != len(subsampling):
            raise ValueError(f"Subsampling indices must be unique. Got {subsampling}.")
