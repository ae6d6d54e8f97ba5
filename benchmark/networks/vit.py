"""ViT-S/16 (DeiT-S) as a plain ``nn.Module``, built from a configuration.

The blocks of Dosovitskiy et al. (arXiv:2010.11929, Eqs. 1-4) at the widths
of DeiT-S (Touvron et al., arXiv:2012.12877, Table 1): a ``patch x patch``
stride-``patch`` convolution embeds the patches, a class token is put in
front of them and a learned position embedding added; ``depth`` pre-norm
blocks follow, each ``x + proj(attention(LN(x)))`` then ``x +
fc2(GELU(fc1(LN(x))))``, attention as plain operations (``softmax(Q Kᵀ /
√(width/heads)) V`` per head); a final LayerNorm, and the class token's
output goes to the linear head.  The input is NHWC ``[N, H, W, 3]``.  The
same module and weights go to the port's entry point and to the plain
reference.

Configuration keys: ``image`` ``[H, W, channels]``, ``patch``, ``width``,
``heads``, ``mlp``, ``depth``, ``num_classes`` and ``init`` (``std`` of the
truncated normal, ``ln_eps``).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def tokens(cfg):
    """Patches plus the class token."""
    h, w, _ = cfg["image"]
    return (h // cfg["patch"]) * (w // cfg["patch"]) + 1


def layers(cfg):
    """The patch convolution as ``{"kind": "conv", ...}`` and every Linear
    as ``{"kind": "dense", "name", "in", "out"}``, in the layout of
    ``cnn3c3d.layers``, for the harness's ``counts.query_parts``.  That
    count takes each dense layer once per sample, not once per token, and
    leaves attention, LayerNorm and the embeddings out: it is not the
    ViT's.  ``counts_vit`` gives the ViT's own."""
    h, w, c = cfg["image"]
    p, d, m = cfg["patch"], cfg["width"], cfg["mlp"]
    out = [{"kind": "conv", "name": "patch", "in": c, "out": d, "kernel": p, "padding": 0,
            "in_hw": (h, w), "out_hw": (h // p, w // p)}]
    for i in range(cfg["depth"]):
        for name, fan_in, fan_out in (("qkv", d, 3 * d), ("proj", d, d), ("fc1", d, m),
                                      ("fc2", m, d)):
            out.append({"kind": "dense", "name": f"blocks.{i}.{name}", "in": fan_in,
                        "out": fan_out})
    out.append({"kind": "dense", "name": "head", "in": d, "out": cfg["num_classes"]})
    return out


class Block(nn.Module):
    """One pre-norm transformer block."""

    def __init__(self, width, heads, mlp, eps):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(width, eps=eps)
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)
        self.norm2 = nn.LayerNorm(width, eps=eps)
        self.fc1 = nn.Linear(width, mlp)
        self.fc2 = nn.Linear(mlp, width)

    def forward(self, x):
        n, t, d = x.shape
        h = self.heads
        qkv = self.qkv(self.norm1(x)).reshape(n, t, 3, h, d // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [N, heads, T, d/heads]
        att = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(d // h), dim=-1)
        x = x + self.proj((att @ v).transpose(1, 2).reshape(n, t, d))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class Net(nn.Module):
    """The network of the module docstring."""

    def __init__(self, cfg):
        super().__init__()
        _, _, c = cfg["image"]
        d, eps = cfg["width"], cfg["init"]["ln_eps"]
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, tokens(cfg), d))
        self.patch = nn.Conv2d(c, d, cfg["patch"], stride=cfg["patch"])
        self.blocks = nn.ModuleList(Block(d, cfg["heads"], cfg["mlp"], eps)
                                    for _ in range(cfg["depth"]))
        self.norm = nn.LayerNorm(d, eps=eps)
        self.head = nn.Linear(d, cfg["num_classes"])

    def forward(self, x):
        x = self.patch(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)  # [N, HW, D]
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.head(self.norm(x)[:, 0])


def build(cfg, device, generator):
    """The network on ``device`` with its weights drawn from ``generator``
    in one call: a normal truncated at two standard deviations, of std
    ``cfg["init"]["std"]``, for every weight matrix (the patch convolution,
    each Linear, the head) and for the class token and the position
    embedding; zero biases; LayerNorm weights one and biases zero."""
    with torch.device("meta"):
        net = Net(cfg)
    net = net.to_empty(device=device).eval()
    std = cfg["init"]["std"]
    norm_weights = [m.weight for m in net.modules() if isinstance(m, nn.LayerNorm)]
    drawn = [p for p in net.parameters() if p.dim() > 1]
    # inverse CDF of the normal truncated to [-2, 2]: u uniform over
    # [Φ(-2), Φ(2)], x = √2 erfinv(2u − 1)
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.rand(sum(p.numel() for p in drawn), generator=generator, device=device,
                   dtype=torch.float64)
    flat = (math.sqrt(2) * torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1) * std).float()
    with torch.no_grad():
        offset = 0
        for p in drawn:
            p.copy_(flat[offset:offset + p.numel()].view(p.shape))
            offset += p.numel()
        for p in net.parameters():
            if p.dim() == 1:
                p.fill_(1.0 if any(p is w for w in norm_weights) else 0.0)
    return net
