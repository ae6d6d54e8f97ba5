"""Model zoo (counterpart of ``vivit_tpu/models/__init__.py``): CIFAR-10
3c3d and the test fixtures.

Inputs keep the flax layout (NHWC images, ``[N, T, F]`` sequences); conv
layers run NCHW inside.  Each model names its flax counterpart's
submodules in ``flax_names`` (flax module name → port module name) and the
flattens that feed a Dense layer in ``(c, h, w)`` order in ``flax_flatten``
(flax Dense name → the ``(c, h, w)`` shape flattened), which
:func:`vivit_tpu_torch.convert.load_flax` reads to transfer flax weights.
Models with BatchNorm or Dropout must be in ``eval()`` for the GGN: the
train-mode forward couples samples or draws noise
(:func:`vivit_tpu_torch.utils.checks.check_model_fn` catches it).
"""

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class MLP(nn.Module):
    """Fully-connected net, ``activation`` between layers (test fixture)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 activation: Callable = torch.tanh):
        super().__init__()
        self.activation = activation
        self.flax_names = {}
        for i, f in enumerate(features):
            setattr(self, f"dense{i}", nn.Linear(in_features, f))
            self.flax_names[f"Dense_{i}"] = f"dense{i}"
            in_features = f
        self.flax_flatten = {}
        self.depth = len(features)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.depth):
            x = getattr(self, f"dense{i}")(x)
            if i < self.depth - 1:
                x = self.activation(x)
        return x


class SmallCNN(nn.Module):
    """Conv 4@3x3 → sigmoid → max-pool 2x2 → Dense (test fixture)."""

    def __init__(self, in_channels: int = 1, image_size: int = 6, num_classes: int = 3):
        super().__init__()
        side = (image_size - 2) // 2
        self.conv0 = nn.Conv2d(in_channels, 4, 3)
        self.dense0 = nn.Linear(4 * side * side, num_classes)
        self.flax_names = {"Conv_0": "conv0", "Dense_0": "dense0"}
        self.flax_flatten = {"Dense_0": (4, side, side)}

    def forward(self, x):
        x = F.max_pool2d(torch.sigmoid(self.conv0(_nchw(x))), 2, 2)
        return self.dense0(x.flatten(1))


class BatchNormNet(nn.Module):
    """Dense → BatchNorm (eval) → tanh → Dense (test fixture)."""

    def __init__(self, in_features: int = 5, hidden: int = 8, num_classes: int = 3):
        super().__init__()
        self.dense0 = nn.Linear(in_features, hidden)
        self.norm = nn.BatchNorm1d(hidden, eps=1e-5)
        self.dense1 = nn.Linear(hidden, num_classes)
        self.flax_names = {"Dense_0": "dense0", "BatchNorm_0": "norm", "Dense_1": "dense1"}
        self.flax_flatten = {}

    def forward(self, x):
        x = self.norm(self.dense0(x.reshape(x.shape[0], -1)))
        return self.dense1(torch.tanh(x))


class BranchedNet(nn.Module):
    """A scaled identity branch beside a tanh branch (test fixture)."""

    def __init__(self, in_features: int = 5, hidden: int = 6, num_classes: int = 3):
        super().__init__()
        self.dense0 = nn.Linear(in_features, hidden)
        self.dense1 = nn.Linear(hidden, hidden)
        self.dense2 = nn.Linear(hidden, num_classes)
        self.flax_names = {f"Dense_{i}": f"dense{i}" for i in range(3)}
        self.flax_flatten = {}

    def forward(self, x):
        h = self.dense0(x.reshape(x.shape[0], -1))
        return self.dense2(torch.tanh(self.dense1(h)) + 0.5 * h)


class KitchenSinkNet(nn.Module):
    """Padding, conv, avg-pool, Dropout (eval), a Dense on an input with
    extra dimensions ``[N, h, w, C]``, then a Dense (test fixture)."""

    def __init__(self, in_channels: int = 2, image_size: int = 6, num_classes: int = 3):
        super().__init__()
        side = image_size // 2
        self.conv0 = nn.Conv2d(in_channels, 3, 3)
        self.dropout = nn.Dropout(0.3)
        self.dense0 = nn.Linear(3, 4)
        self.dense1 = nn.Linear(side * side * 4, num_classes)
        self.flax_names = {"Conv_0": "conv0", "Dense_0": "dense0", "Dense_1": "dense1"}
        self.flax_flatten = {}

    def forward(self, x):
        x = F.pad(_nchw(x), (1, 1, 1, 1))
        x = F.avg_pool2d(torch.relu(self.conv0(x)), 2, 2)
        x = torch.tanh(self.dense0(_nhwc(self.dropout(x))))  # [N, h, w, 4]
        return self.dense1(x.flatten(1))


class ConvTransposeNet(nn.Module):
    """ConvTranspose 2@3x3, stride 2 → tanh → Dense (test fixture).

    flax's ``ConvTranspose`` (``padding="SAME"``, kernel not transposed)
    correlates the stride-dilated input, padded (2, 1) per side, with its
    kernel: the output is ``stride × input`` wide.  ``nn.ConvTranspose2d``
    pads both sides alike (``k − 1 − padding``; ``output_padding`` only
    adds to the end), so it runs with ``padding=0`` (pads (2, 2)) and the
    last row and column are cut: the first ``stride × input`` positions
    line up with flax's.  The weight is flax's kernel flipped in space
    (:func:`vivit_tpu_torch.convert.load_flax`).
    """

    def __init__(self, in_channels: int = 1, image_size: int = 3, num_classes: int = 3):
        super().__init__()
        self.out_side = 2 * image_size
        self.convt0 = nn.ConvTranspose2d(in_channels, 2, 3, stride=2)
        self.dense0 = nn.Linear(self.out_side * self.out_side * 2, num_classes)
        self.flax_names = {"ConvTranspose_0": "convt0", "Dense_0": "dense0"}
        self.flax_flatten = {}

    def forward(self, x):
        x = self.convt0(_nchw(x))[..., :self.out_side, :self.out_side]
        return self.dense0(_nhwc(torch.tanh(x)).flatten(1))


class TinyTransformer(nn.Module):
    """One single-head attention block with a residual feed-forward,
    mean-pooled classifier (test fixture).  Input ``[N, T, F]``."""

    def __init__(self, in_features: int = 5, d_model: int = 8, num_classes: int = 3):
        super().__init__()
        self.d_model = d_model
        self.embed = nn.Linear(in_features, d_model)
        self.query = nn.Linear(d_model, d_model, bias=False)
        self.key = nn.Linear(d_model, d_model, bias=False)
        self.value = nn.Linear(d_model, d_model, bias=False)
        self.ff_out = nn.Linear(d_model, d_model)
        self.ff_in = nn.Linear(d_model, d_model)
        self.head = nn.Linear(d_model, num_classes)
        self.flax_names = {"Dense_0": "embed", "Dense_1": "query", "Dense_2": "key",
                           "Dense_3": "value", "Dense_4": "ff_out", "Dense_5": "ff_in",
                           "Dense_6": "head"}
        self.flax_flatten = {}

    def forward(self, x):
        h = self.embed(x)
        q, k, v = self.query(h), self.key(h), self.value(h)
        att = torch.softmax(torch.einsum("ntd,nsd->nts", q, k) / self.d_model ** 0.5, dim=-1)
        h = h + torch.einsum("nts,nsd->ntd", att, v)
        h = h + self.ff_out(torch.tanh(self.ff_in(h)))
        return self.head(h.mean(dim=1))


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
        self.flax_names = {"Conv_0": "conv0", "Conv_1": "conv1", "Conv_2": "conv2",
                           "Dense_0": "dense0", "Dense_1": "dense1", "Dense_2": "dense2"}
        self.flax_flatten = {"Dense_0": (128, 3, 3)}

    def forward(self, x):
        x = _nchw(x)
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
