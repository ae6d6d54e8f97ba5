"""DeepOBS CIFAR-10 3c3d as a plain ``nn.Module``, built from a configuration.

Three convolutions, each followed by ReLU and a 3x3 stride-2 max-pool, then
two ReLU dense layers and the linear output layer.  The input is NHWC
``[N, H, W, 3]``; the layers run NCHW and the flatten before the first
dense layer is in ``(c, h, w)`` order.  The same module and weights go to
the port's entry point and to the plain reference.

Configuration keys: ``image`` ``[H, W, channels]``, ``conv`` (a list of
``{"out", "kernel", "padding"}``), ``pool`` (``{"kernel", "stride",
"padding"}``), ``dense`` (hidden widths) and ``num_classes``.
"""

import math

import torch
from torch import nn


def _out(size, kernel, stride, padding):
    return (size + 2 * padding - kernel) // stride + 1


def layers(cfg):
    """The layers with weights, in order: ``{"kind": "conv", "name", "in",
    "out", "kernel", "padding", "in_hw", "out_hw"}`` or ``{"kind": "dense",
    "name", "in", "out"}``.  The counts of the benchmark read these."""
    h, w, channels = cfg["image"]
    pool = cfg["pool"]
    out = []
    for i, conv in enumerate(cfg["conv"]):
        k, p = conv["kernel"], conv["padding"]
        oh, ow = _out(h, k, 1, p), _out(w, k, 1, p)
        out.append({"kind": "conv", "name": f"conv{i}", "in": channels, "out": conv["out"],
                    "kernel": k, "padding": p, "in_hw": (h, w), "out_hw": (oh, ow)})
        h = _out(oh, pool["kernel"], pool["stride"], pool["padding"])
        w = _out(ow, pool["kernel"], pool["stride"], pool["padding"])
        channels = conv["out"]
    width = channels * h * w
    for i, hidden in enumerate([*cfg["dense"], cfg["num_classes"]]):
        out.append({"kind": "dense", "name": f"dense{i}", "in": width, "out": hidden})
        width = hidden
    return out


class Net(nn.Module):
    """The network of :func:`layers` (ReLU after every layer but the last)."""

    def __init__(self, cfg):
        super().__init__()
        spec = layers(cfg)
        pool = cfg["pool"]
        self.pool = nn.MaxPool2d(pool["kernel"], pool["stride"], padding=pool["padding"])
        self.convs = nn.ModuleList(
            nn.Conv2d(s["in"], s["out"], s["kernel"], padding=s["padding"])
            for s in spec if s["kind"] == "conv")
        self.denses = nn.ModuleList(
            nn.Linear(s["in"], s["out"]) for s in spec if s["kind"] == "dense")

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = self.pool(torch.relu(conv(x)))
        x = x.flatten(1)
        for dense in self.denses[:-1]:
            x = torch.relu(dense(x))
        return self.denses[-1](x)


def build(cfg, device, generator):
    """The network on ``device`` with its weights drawn from ``generator``
    in one call: LeCun-normal weights (std ``1/sqrt(fan_in)``) and normal
    biases of std ``cfg["init"]["bias_std"]``."""
    with torch.device("meta"):
        net = Net(cfg)
    net = net.to_empty(device=device).eval()
    params = list(net.parameters())
    flat = torch.randn(sum(p.numel() for p in params), generator=generator, device=device)
    with torch.no_grad():
        offset = 0
        for p in params:
            part = flat[offset:offset + p.numel()].view(p.shape)
            scale = (cfg["init"]["bias_std"] if p.dim() == 1
                     else 1.0 / math.sqrt(p[0].numel()))
            p.copy_(part * scale)
            offset += p.numel()
    return net
