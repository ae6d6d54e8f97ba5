"""Weight transfer from the flax layout to the port's modules.

A port model names its flax counterpart's submodules in ``flax_names`` and
the ``(c, h, w)`` flattens that feed a Dense layer in ``flax_flatten``
(:mod:`vivit_tpu_torch.models`).  Leaves map by the type of the port
module:

* ``nn.Linear``: the kernel ``[in, out]`` transposed; after a ``(c, h, w)``
  flatten its input rows reordered from flax's ``(h, w, c)``;
* ``nn.Conv2d``: ``[kh, kw, I, O]`` → ``[O, I, kh, kw]``;
* ``nn.ConvTranspose2d``: ``[kh, kw, I, O]`` → ``[I, O, kh, kw]``, flipped in
  space (flax correlates with its kernel, PyTorch with the flipped weight);
* BatchNorm/LayerNorm: ``scale``/``bias`` → ``weight``/``bias``, the
  ``batch_stats`` ``mean``/``var`` → ``running_mean``/``running_var``.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


def _kind(module: nn.Module) -> str:
    if type(module) is nn.Linear:
        return "dense"
    if type(module) is nn.ConvTranspose2d:
        return "conv_transpose"
    if type(module) is nn.Conv2d:
        return "conv"
    return "other"


def _port_layout(kind: str, leaf: str, stacked: np.ndarray,
                 flatten: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """One flax leaf with a leading stack axis, ``[K, *flax shape]`` →
    ``[K, *port shape]`` (rules in the module docstring)."""
    a = np.array(stacked, np.float32)
    if leaf == "kernel":
        if kind == "conv":
            a = a.transpose(0, 4, 3, 1, 2)
        elif kind == "conv_transpose":
            a = a.transpose(0, 3, 4, 1, 2)[..., ::-1, ::-1]
        elif flatten is not None:
            c, h, w = flatten
            k, _, out = a.shape
            a = a.reshape(k, h, w, c, out).transpose(0, 4, 3, 1, 2).reshape(k, out, -1)
        else:
            a = a.transpose(0, 2, 1)
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaf_target(model: nn.Module, flax_name: str, leaf: str):
    """``(port name, kind, flatten)`` of one flax leaf."""
    prefix = model.flax_names[flax_name]
    kind = _kind(model.get_submodule(prefix))
    return f"{prefix}.{_LEAF_NAMES[leaf]}", kind, model.flax_flatten.get(flax_name)


def state_dict_from_flax(model: nn.Module, variables: dict) -> Dict[str, torch.Tensor]:
    """flax ``variables`` (``{"params": ..., "batch_stats": ...}``, nested
    dicts of numpy arrays) → the port model's ``state_dict`` entries."""
    out = {}
    for collection in variables.values():
        for flax_name, leaves in collection.items():
            for leaf, value in leaves.items():
                name, kind, flatten = _leaf_target(model, flax_name, leaf)
                out[name] = _port_layout(kind, leaf, np.asarray(value)[None], flatten)[0]
    return out


def load_flax(model: nn.Module, variables: dict) -> nn.Module:
    """Load flax ``variables`` into ``model`` (:func:`state_dict_from_flax`);
    raises if a parameter or buffer other than BatchNorm's
    ``num_batches_tracked`` is left without a value.  Returns ``model``."""
    missing, unexpected = model.load_state_dict(state_dict_from_flax(model, variables),
                                                strict=False)
    missing = [m for m in missing if not m.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"flax variables do not match the model: missing {missing}, "
                         f"unexpected {unexpected}")
    return model


def params_from_flax(params_np: dict) -> dict:
    """flax 3c3d params (nested dict of numpy arrays) → a ``state_dict`` for
    :class:`vivit_tpu_torch.models.CNN3c3d`."""
    from vivit_tpu_torch.models import CNN3c3d

    num_classes = np.asarray(params_np["Dense_2"]["kernel"]).shape[-1]
    return state_dict_from_flax(CNN3c3d(num_classes), {"params": params_np})


def leaves_from_flax(leaves: dict, model: Optional[nn.Module] = None) -> dict:
    """Stacked parameter-space vectors in the flax layout, ``{"Dense_1/kernel":
    [K, *flax shape], ...}`` (as the JAX package's ``eigh_topk`` returns
    them, keyed by their paths) → ``{"dense1.weight": [K, *port shape],
    ...}`` for ``model`` (default: 3c3d), with the layout rules of
    :func:`state_dict_from_flax`."""
    if model is None:
        from vivit_tpu_torch.models import CNN3c3d

        model = CNN3c3d()
    out = {}
    for path, value in leaves.items():
        flax_name, leaf = path.split("/")
        name, kind, flatten = _leaf_target(model, flax_name, leaf)
        out[name] = _port_layout(kind, leaf, value, flatten)
    return out
