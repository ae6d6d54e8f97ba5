"""Weight transfer from the flax layout to the port's modules."""

import numpy as np
import torch

# flax module name → port module name (CNN3c3d)
_NAMES = {
    "Conv_0": "conv0", "Conv_1": "conv1", "Conv_2": "conv2",
    "Dense_0": "dense0", "Dense_1": "dense1", "Dense_2": "dense2",
}
# (channels, height, width) of the flatten that feeds Dense_0 in CNN3c3d
_FLATTEN_CHW = (128, 3, 3)


def _port_layout(flax_name: str, leaf: str, stacked: np.ndarray) -> torch.Tensor:
    """One flax leaf with a leading stack axis, ``[K, *flax shape]`` →
    ``[K, *port shape]``.

    Conv kernels ``[kh, kw, I, O]`` become ``[O, I, kh, kw]``; Dense kernels
    ``[in, out]`` are transposed.  The first Dense layer consumes a flatten:
    flax flattens NHWC in ``(h, w, c)`` order, the port NCHW in ``(c, h, w)``
    order, so its input rows are reordered.  Biases keep their layout.
    """
    a = np.array(stacked, np.float32)
    if leaf == "kernel":
        if a.ndim == 5:
            a = a.transpose(0, 4, 3, 1, 2)
        elif flax_name == "Dense_0":
            c, h, w = _FLATTEN_CHW
            k, _, out = a.shape
            a = a.reshape(k, h, w, c, out).transpose(0, 4, 3, 1, 2).reshape(k, out, -1)
        else:
            a = a.transpose(0, 2, 1)
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_name(flax_name: str, leaf: str) -> str:
    return f"{_NAMES[flax_name]}.{'weight' if leaf == 'kernel' else 'bias'}"


def params_from_flax(params_np: dict) -> dict:
    """flax 3c3d params (nested dict of numpy arrays) → a ``state_dict`` for
    :class:`vivit_tpu_torch.models.CNN3c3d` (layouts as in
    :func:`_port_layout`)."""
    return {
        _port_name(flax_name, leaf): _port_layout(flax_name, leaf, value[None])[0]
        for flax_name in sorted(params_np)
        for leaf, value in params_np[flax_name].items()
    }


def leaves_from_flax(leaves: dict) -> dict:
    """Stacked parameter-space vectors in the flax layout, ``{"Dense_1/kernel":
    [K, *flax shape], ...}`` (as the JAX package's ``eigh_topk`` returns
    them, keyed by their paths) → ``{"dense1.weight": [K, *port shape],
    ...}``, with the layout rules of :func:`params_from_flax`."""
    out = {}
    for path, value in leaves.items():
        flax_name, leaf = path.split("/")
        out[_port_name(flax_name, leaf)] = _port_layout(flax_name, leaf, value)
    return out
