"""Linear algebra computation API (counterpart of ``vivit_tpu/linalg/``)."""

from vivit_tpu_torch.linalg.eigh import EighComputation, eigh_topk
from vivit_tpu_torch.linalg.eigvalsh import EigvalshComputation, eigvalsh
from vivit_tpu_torch.linalg.utils import keep_all, keep_nonzero, keep_top_k

__all__ = [
    "EigvalshComputation",
    "EighComputation",
    "eigh_topk",
    "eigvalsh",
    "keep_all",
    "keep_nonzero",
    "keep_top_k",
]
