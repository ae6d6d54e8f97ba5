"""Weight transfer from the flax layout to the port's modules."""

import numpy as np
import torch

# flax module name → port module name (CNN3c3d)
_NAMES = {
    "Conv_0": "conv0", "Conv_1": "conv1", "Conv_2": "conv2",
    "Dense_0": "dense0", "Dense_1": "dense1", "Dense_2": "dense2",
}


def params_from_flax(params_np: dict) -> dict:
    """flax 3c3d params (nested dict of numpy arrays) → a ``state_dict`` for
    :class:`vivit_tpu_torch.models.CNN3c3d`.

    Conv kernels ``[kh, kw, I, O]`` become ``[O, I, kh, kw]``; Dense kernels
    ``[in, out]`` are transposed.  The first Dense layer consumes a flatten:
    flax flattens NHWC in ``(h, w, c)`` order, the port NCHW in ``(c, h, w)``
    order, so its input rows are reordered.
    """
    state = {}
    last_channels = None
    for flax_name in sorted(params_np):
        name = _NAMES[flax_name]
        kernel = np.asarray(params_np[flax_name]["kernel"], np.float32)
        bias = np.asarray(params_np[flax_name]["bias"], np.float32)
        if kernel.ndim == 4:
            weight = kernel.transpose(3, 2, 0, 1)
            last_channels = kernel.shape[-1]
        else:
            weight = kernel.T
            if flax_name == "Dense_0":
                out = kernel.shape[1]
                side = int(round(np.sqrt(kernel.shape[0] // last_channels)))
                weight = (kernel.reshape(side, side, last_channels, out)
                          .transpose(3, 2, 0, 1).reshape(out, -1))
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(weight))
        state[f"{name}.bias"] = torch.from_numpy(bias.copy())
    return state
