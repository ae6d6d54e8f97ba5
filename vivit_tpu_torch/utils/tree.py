"""Path addressing over parameter dicts (counterpart of
``vivit_tpu/utils/tree.py``).

The port's parameter trees are flat dicts ``{name: Tensor}`` keyed by
``named_parameters()`` names (``"dense0.weight"``, or ``"0.weight"`` inside
``nn.Sequential``); ``Vᵀ`` dicts share those keys.  Leaf order is the dict's
insertion order, where the JAX package sorts dict keys: only
:func:`ravel`/:func:`unravel_like`, :func:`ravel_batched` and the default
group order see the difference, because a Gram is a sum over leaves.
"""

from typing import Any, Dict, List, Sequence, Tuple

import torch


def leaf_paths(tree: Dict[str, Any]) -> List[str]:
    """The names of all leaves, in insertion order."""
    return list(tree)


def flatten_with_paths(tree: Dict[str, Any]) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in insertion order."""
    return list(tree.items())


def num_params(tree: Dict[str, torch.Tensor]) -> int:
    """Total number of scalars in the tree."""
    return sum(leaf.numel() for leaf in tree.values())


def ravel(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """All leaves concatenated into one flat vector."""
    return torch.cat([leaf.reshape(-1) for leaf in tree.values()])


def unravel_like(vec: torch.Tensor, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`ravel`: ``vec`` split into ``tree``'s names and shapes."""
    out, offset = {}, 0
    for name, leaf in tree.items():
        out[name] = vec[offset:offset + leaf.numel()].reshape(leaf.shape)
        offset += leaf.numel()
    return out


def ravel_batched(tree: Dict[str, torch.Tensor], num_leading: int = 1) -> torch.Tensor:
    """Leaves ``[B1, ..., Bk, *s]`` sharing ``num_leading`` batch axes →
    ``[B1·...·Bk, D]``, concatenated along the last axis."""
    mats = []
    for leaf in tree.values():
        lead = 1
        for d in leaf.shape[:num_leading]:
            lead *= d
        mats.append(leaf.reshape(lead, -1))
    return torch.cat(mats, dim=1)


def select_paths(tree: Dict[str, Any], paths: Sequence[str]) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs for the requested names, in requested order.

    Raises:
        ValueError: If a requested name is not in ``tree``.
    """
    missing = [p for p in paths if p not in tree]
    if missing:
        raise ValueError(
            f"Parameter paths not found in pytree: {missing}. "
            f"Available: {sorted(tree)}"
        )
    return [(p, tree[p]) for p in paths]


def subtree_mask(tree: Dict[str, Any], paths: Sequence[str]) -> Dict[str, bool]:
    """``{name: name in paths}`` over the tree's leaves."""
    wanted = set(paths)
    return {name: name in wanted for name in tree}


def tree_take(tree: Dict[str, torch.Tensor], indices, axis: int = 0) -> Dict[str, torch.Tensor]:
    """``index_select`` along ``axis`` applied to every leaf."""
    out = {}
    for name, leaf in tree.items():
        idx = torch.as_tensor(indices, device=leaf.device)
        out[name] = leaf.index_select(axis, idx)
    return out
