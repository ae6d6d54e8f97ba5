"""Linear algebra computation API (counterpart of ``vivit_tpu/linalg/``;
``eigh_topk`` only in this slice)."""

from vivit_tpu_torch.linalg.eigh import eigh_topk

__all__ = ["eigh_topk"]
