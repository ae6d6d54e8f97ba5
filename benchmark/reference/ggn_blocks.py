"""The plain reference for networks too wide for :class:`ggn.Columns`, whose
``V`` of ``[C', N, D]`` would not fit on the card in float64 (ViT-S/16 at
N=128: 200 GB): the same Gram, accumulated over groups of parameters.

Plain PyTorch, independent of the program under test (it imports nothing
of it), and the same arithmetic as :mod:`ggn` group by group:

* the parameters in ``named_parameters`` order, cut into groups of
  consecutive parameters of at most ``group_numel`` elements (a larger
  parameter alone);
* per group, ``V_g`` of ``[C', N, D_g]``: per-sample Jacobians of the
  logits w.r.t. that group alone (``torch.func``, the other parameters
  held), in blocks of samples, times the loss factors of :mod:`ggn`
  (``loss_factors``, deflated);
* per parameter of the group, its block of ``Vᵀ V`` added to the Gram: the
  weight of a Linear layer that sees a 2-D input in ``dtype``, every other
  block with its operands rounded to ``low`` (through float32, in which the
  program stores them) and their products summed in ``dtype``
  (:func:`low_gram`), as the program computes the blocks it keeps
  factored per sample (a 2-D Linear weight) in f32 and all others, token
  blocks included, on the Gram's operand precision.  The sums are the
  reference's own arithmetic, exact in float64: an H100's bf16 GEMM with a
  float32 output, which :func:`ggn.low_gram` calls, sums a long block with
  an error that grows with its length (1.6e-3 of the exact Gram over
  589,824 columns of random operands), more than the program's own.

One group's ``V_g`` is held at a time: ``8 · C'·N · group_numel`` bytes in
float64, beside the network and one block's Jacobian.
"""

import torch
from torch import nn
from torch.func import functional_call, jacrev, vmap

from .ggn import loss_factors, precision


def low_gram(block, low, dtype):
    """``block @ block.T`` of operands rounded to ``low`` through float32,
    the products summed in ``dtype`` (a product of two bf16 values is exact
    in float32 and in TF32)."""
    b = block.float().to(low).to(dtype)
    return b @ b.T


def dense_2d_weights(module, x):
    """The weights of the ``nn.Linear`` layers whose input is 2-D, by one
    forward of ``x`` with hooks."""
    found, handles = set(), []
    for name, m in module.named_modules():
        if isinstance(m, nn.Linear):
            def hook(_, inputs, out, name=name):
                if inputs[0].dim() == 2:
                    found.add(f"{name}.weight" if name else "weight")
            handles.append(m.register_forward_hook(hook))
    try:
        with torch.no_grad():
            module(x)
    finally:
        for h in handles:
            h.remove()
    return found


def groups(sizes, group_numel):
    """``[[index, ...], ...]``: consecutive parameters of at most
    ``group_numel`` elements each (a larger parameter alone)."""
    out, count = [], 0
    for i, size in enumerate(sizes):
        if out and count + size <= group_numel:
            out[-1].append(i)
            count += size
        else:
            out.append([i])
            count = size
    return out


def gram(module, X, *, low, dtype, tf32, group_numel=3 << 20, block=8, low_names=None):
    """``[C'N, C'N]`` deflated Gram of the batch, accumulated over groups;
    ``low_names`` (default: every parameter but the 2-D Linear weights) take
    the ``low`` operand rounding."""
    params = {name: p.detach().to(dtype) for name, p in module.named_parameters()}
    names = list(params)
    if low_names is None:
        dense = dense_2d_weights(module, X[:1])
        low_names = [n for n in names if n not in dense]
    X = X.to(dtype)
    with precision(tf32), torch.no_grad():
        f = functional_call(module, params, (X,))
    factors = loss_factors(f, True)  # [N, C', C]
    n, cf = X.shape[0], factors.shape[1]
    g = torch.zeros((cf * n, cf * n), dtype=dtype, device=X.device)
    for group in groups([params[name].numel() for name in names], group_numel):
        part = {names[i]: params[names[i]] for i in group}
        rest = {k: v for k, v in params.items() if k not in part}

        def logits(p, x, rest=rest):
            return functional_call(module, {**rest, **p}, (x[None],))[0]

        per_sample = vmap(jacrev(logits), in_dims=(None, 0))
        sizes = [part[k].numel() for k in part]
        v = torch.empty((cf, n, sum(sizes)), dtype=dtype, device=X.device)
        with precision(tf32):
            for i in range(0, n, block):
                jac = per_sample(part, X[i:i + block])  # {name: [b, C, *shape]}
                flat = torch.cat([jac[k].flatten(2) for k in part], dim=2)
                del jac
                v[:, i:i + block] = torch.einsum("bak,bkd->abd", factors[i:i + block], flat)
                del flat
            flat_v = v.reshape(cf * n, -1)
            offset = 0
            for k, size in zip(part, sizes):
                b = flat_v[:, offset:offset + size]
                if k in low_names:
                    g += low_gram(b, low, dtype)
                else:
                    g += b @ b.T
                offset += size
        del v, flat_v
    return g


def spectrum(module, X, y, *, low, dtype=torch.float64, tf32=False, group_numel=3 << 20,
             block=8):
    """The ascending GGN spectrum of the batch, ``N*C`` values: the
    deflated Gram's ``(C-1) N`` eigenvalues and ``N`` exact zeros."""
    g = gram(module, X, low=low, dtype=dtype, tf32=tf32, group_numel=group_numel,
             block=block)
    evals = torch.linalg.eigvalsh(g)
    return torch.sort(torch.cat([evals.new_zeros(X.shape[0]), evals])).values
