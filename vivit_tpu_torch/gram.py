"""Gram-space helpers (counterpart of ``vivit_tpu/gram.py``; ``normalize``
only in this slice)."""

from typing import List, Sequence

import torch


def normalize(leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Normalize stacked vectors in parameter-list format by their global
    norm: each ``leaves[i]`` is ``[K, *shape]``, vector ``k`` spread across
    all leaves."""
    sq = sum(leaf.reshape(leaf.shape[0], -1).square().sum(dim=1) for leaf in leaves)
    inv = 1.0 / torch.sqrt(sq)
    return [leaf * inv.reshape(-1, *(1,) * (leaf.dim() - 1)) for leaf in leaves]
