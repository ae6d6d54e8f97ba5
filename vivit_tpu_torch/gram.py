"""Gram-space tensor algebra (counterpart of ``vivit_tpu/gram.py``).

Every contraction is flattened to a 2-D matmul ``[CF·S, D_leaf]``.  The Gram
index is ``(c, n)`` factor-major, ``flat = c·S + n``.  ``precision`` is the
operand dtype of a contraction (``None`` full f32, ``torch.bfloat16``: bf16
operands and an f32 result; :data:`vivit_tpu_torch.precision._PRECISIONS`).
"""

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from vivit_tpu_torch.precision import dot_t
from vivit_tpu_torch.utils.tree import flatten_with_paths, select_paths


def _pairs(vt: Dict[str, Any], paths: Optional[Sequence[str]]):
    return flatten_with_paths(vt) if paths is None else select_paths(vt, paths)


def _flat(leaf: torch.Tensor) -> torch.Tensor:
    cf, s = leaf.shape[:2]
    return leaf.reshape(cf * s, -1)


def gram_matrix(vt: Dict[str, torch.Tensor], paths: Optional[Sequence[str]] = None,
                precision=None) -> torch.Tensor:
    """``G̃ = Vᵀ V = Σ_p (Vᵀ)_p (Vᵀ)_pᵀ``, ``[CF·S, CF·S]``, accumulated in
    f32 whatever the operand dtype."""
    total = None
    for _, leaf in _pairs(vt, paths):
        g = dot_t(_flat(leaf), _flat(leaf), precision)
        total = g if total is None else total + g
    return total


def reshape_as_square(mat: torch.Tensor) -> torch.Tensor:
    """A ``[CF, S, CF, S]`` (any even-rank) tensor as a square matrix."""
    dim = math.isqrt(mat.numel())
    return mat.reshape(dim, dim)


def pairwise_dot(t: torch.Tensor, start_dim: int = 1, precision=None) -> torch.Tensor:
    """Pairwise dot products over the trailing dims: ``[d_1..d_k, *]`` with
    ``start_dim = k`` → ``[d_1..d_k, d_1..d_k]``."""
    lead = t.shape[:start_dim]
    flat = t.reshape(math.prod(lead), -1)
    return dot_t(flat, flat, precision).reshape(*lead, *lead)


def partial_contract(a: torch.Tensor, b: torch.Tensor, start_dims: Tuple[int, int],
                     precision=None) -> torch.Tensor:
    """Contract the trailing dims of ``a`` and ``b``: the leading dims of
    ``a`` followed by those of ``b``."""
    lead_a, lead_b = a.shape[:start_dims[0]], b.shape[:start_dims[1]]
    fa = a.reshape(math.prod(lead_a), -1)
    fb = b.reshape(math.prod(lead_b), -1)
    return dot_t(fa, fb, precision).reshape(*lead_a, *lead_b)


def v_mat_prod(vt: Dict[str, torch.Tensor], gram_vecs: torch.Tensor,
               paths: Optional[Sequence[str]] = None,
               precision=None) -> Tuple[List[str], List[torch.Tensor]]:
    """Back-projection ``V @ ẽ`` of stacked Gram-space vectors ``[K, CF, S]``
    (or ``[K, CF·S]``): ``(paths, leaves)``, each leaf ``[K, *param.shape]``."""
    pairs = _pairs(vt, paths)
    k = gram_vecs.shape[0]
    # the column count is explicit: reshape with -1 cannot infer it when K == 0
    cf0, s0 = pairs[0][1].shape[:2]
    gv = gram_vecs.reshape(k, cf0 * s0)
    out_paths, out_leaves = [], []
    for p, leaf in pairs:
        proj = dot_t(gv, _flat(leaf).T, precision)
        out_paths.append(p)
        out_leaves.append(proj.reshape(k, *leaf.shape[2:]).to(leaf.dtype))
    return out_paths, out_leaves


def vt_mat_prod(vt: Dict[str, torch.Tensor], mat_leaves: Sequence[torch.Tensor],
                paths: Optional[Sequence[str]] = None, precision=None) -> torch.Tensor:
    """``Vᵀ @ m`` of stacked parameter-space vectors ``[K, *param.shape]``
    aligned with the (selected) leaves → ``[CF·S, K]``."""
    total = None
    for (_, leaf), m in zip(_pairs(vt, paths), mat_leaves):
        r = dot_t(_flat(leaf), m.reshape(m.shape[0], -1), precision)
        total = r if total is None else total + r
    return total


def normalize(leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Normalize stacked vectors in parameter-list format by their global
    norm: each ``leaves[i]`` is ``[K, *shape]``, vector ``k`` spread across
    all leaves."""
    sq = sum(leaf.reshape(leaf.shape[0], -1).square().sum(dim=1) for leaf in leaves)
    inv = 1.0 / torch.sqrt(sq)
    return [leaf * inv.reshape(-1, *(1,) * (leaf.dim() - 1)) for leaf in leaves]
