"""Linear algebra computation API (counterpart of ``vivit_tpu/linalg/``;
``eigh_topk`` and the eigenvalue criteria in this slice)."""

from vivit_tpu_torch.linalg.eigh import eigh_topk
from vivit_tpu_torch.linalg.utils import keep_all, keep_nonzero, keep_top_k

__all__ = ["eigh_topk", "keep_all", "keep_nonzero", "keep_top_k"]
