"""Model zoo (counterpart of ``vivit_tpu/models/__init__.py``; CIFAR-10 3c3d
only in this slice)."""

import numpy as np
import torch
from torch import nn


class CNN3c3d(nn.Module):
    """CIFAR-10 3c3d (DeepOBS): 3 conv + 3 dense, ReLU activations.

    Conv 64@5x5 → pool → Conv 96@3x3 → pool → Conv 128@3x3 (pad 1) → pool →
    Dense 512 → Dense 256 → Dense ``num_classes``; every pool is
    ``MaxPool2d(3, 2, padding=1)``, the geometry of the flax model's
    ``max_pool`` with ``((1, 1), (1, 1))`` padding.

    The input is NHWC ``[N, 32, 32, 3]`` as in the JAX package; the layers
    run NCHW, and the flatten before ``dense0`` is in ``(c, h, w)`` order
    (:func:`vivit_tpu_torch.convert.params_from_flax` reorders the flax
    kernel to match).
    """

    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.conv0 = nn.Conv2d(3, 64, 5)
        self.conv1 = nn.Conv2d(64, 96, 3)
        self.conv2 = nn.Conv2d(96, 128, 3, padding=1)
        self.pool = nn.MaxPool2d(3, 2, padding=1)
        self.dense0 = nn.Linear(128 * 3 * 3, 512)
        self.dense1 = nn.Linear(512, 256)
        self.dense2 = nn.Linear(256, num_classes)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = self.pool(torch.relu(self.conv0(x)))
        x = self.pool(torch.relu(self.conv1(x)))
        x = self.pool(torch.relu(self.conv2(x)))
        x = x.flatten(1)
        x = torch.relu(self.dense0(x))
        x = torch.relu(self.dense1(x))
        return self.dense2(x)


def cnn3c3d_flax_params(seed: int = 0, num_classes: int = 10) -> dict:
    """Random 3c3d weights in the flax layout, made with numpy from ``seed``.

    Kernels are LeCun-normal (std ``1/√fan_in``), biases normal with std
    0.05.  The same arrays feed the flax model directly and the port through
    :func:`~vivit_tpu_torch.convert.params_from_flax`, so both see identical
    weights.
    """
    rng = np.random.default_rng(seed)
    shapes = {
        "Conv_0": (5, 5, 3, 64),
        "Conv_1": (3, 3, 64, 96),
        "Conv_2": (3, 3, 96, 128),
        "Dense_0": (128 * 3 * 3, 512),
        "Dense_1": (512, 256),
        "Dense_2": (256, num_classes),
    }
    params = {}
    for name, shape in shapes.items():
        fan_in = int(np.prod(shape[:-1]))
        params[name] = {
            "kernel": (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32),
            "bias": (0.05 * rng.standard_normal(shape[-1])).astype(np.float32),
        }
    return params
