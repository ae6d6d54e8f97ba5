"""Matmul precision: the JAX package's precision names in PyTorch terms.

JAX ``"highest"`` is full f32.  PyTorch on a CUDA card runs f32 matmuls in
full f32 by default, but f32 convolutions go through cuDNN in TF32, which
keeps about three decimal digits; :func:`full_f32` turns off both.  JAX
``"high"`` is bf16_3x, ~1e-5 relative.  Its counterpart here is
:func:`matmul`'s three-pass TF32 product, within twice the f32
product's error at the strip basis's shapes on an H100, which
``eigh_dc``'s basis takes at ``"high"`` (its ``basis_prec``,
``deskew_prec`` and ``q_prec``).  As a pipeline-wide name
(:func:`matmul_precision`), ``"high"`` runs in full f32.

``_PRECISIONS`` is the counterpart of the map in
``vivit_tpu/linalg/eigvalsh.py``: a name to the operand dtype of a Gram
contraction (``None`` = full f32).  ``"bf16"`` rounds the operands to bf16
and keeps an f32 result.
"""

from contextlib import contextmanager

import torch

_PRECISIONS = {
    "highest": None,
    "high": None,
    "bf16": torch.bfloat16,
    "default": torch.bfloat16,
    None: None,
}


@contextmanager
def full_f32():
    """Run f32 matmuls and convolutions in full f32 (TF32 off), restoring
    both flags on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def matmul_precision(precision):
    """Context for a pipeline-wide ``precision`` name: ``"highest"``,
    ``"high"`` and ``None`` all run in full f32 (only ``eigh_dc``'s basis
    knobs take ``"high"`` as three TF32 passes, :func:`matmul`)."""
    if precision not in ("highest", "high", None):
        raise ValueError(
            f"precision {precision!r} is not supported by the port "
            "(use 'highest' or 'high'; as a pipeline-wide name both run in "
            "full f32)"
        )
    return full_f32()


# the least side (m, n and k) of a "high" product that runs as three TF32
# passes (:func:`matmul`).  Placed on an H100 where cuBLAS's three passes,
# their splits and their k-chunks crossed the f32 product (1.07x at 2048
# for n³ products).  The kernel that runs them now crosses it at 1280 for
# n³ products (1.2-1.5x there, 1.6x at 2048) and at 768 for [2, n, n]
# batches (1.0-1.3x there, 1.9-2.0x at 2048): a lower threshold would engage more
THREE_PASS_MIN = 2048
# "high" products run as three TF32 passes, and those kept in f32 by shape,
# since the last reset (``THREE_PASS = 0``).  A replay of captured CUDA
# graphs makes no Python call and adds nothing
THREE_PASS = 0
THREE_PASS_DECLINED = 0


def tf32_split(x: torch.Tensor):
    """``(hi, lo)`` of f32 ``x``: ``hi`` is ``x`` rounded to TF32 (to
    nearest, ties away from zero: the low 13 mantissa bits zero), ``lo = x -
    hi``, exact in f32, so ``hi + lo == x`` bit for bit."""
    if x.dtype != torch.float32:
        raise TypeError(f"the TF32 split takes float32, got {x.dtype}")
    hi = torch.add(x.view(torch.int32), 0x1000).bitwise_and_(-0x2000).view(torch.float32)
    return hi, x - hi


def matmul(a: torch.Tensor, b: torch.Tensor, precision=None) -> torch.Tensor:
    """``a @ b`` of f32 operands at a JAX precision name, the counterpart
    of the JAX package's ``_mm(a, b, prec)`` (``vivit_tpu/eigdc.py``).

    ``"high"`` with every side (``m``, ``n``, ``k``) at least
    :data:`THREE_PASS_MIN` runs as three TF32 products, 2-D or equal-batch
    3-D (:mod:`vivit_tpu_torch.kernels.three_pass`): each operand split
    once (``hi`` its TF32 rounding, ``lo`` the exact rest:
    :func:`tf32_split`), ``lo·hi + hi·lo + hi·hi`` of every 32 positions of
    ``k`` summed in f32 and added to the output.  On a CUDA card that is one
    launch of a hand-written Hopper kernel, which splits on chip; on the
    CPU its plain version.  The tensor cores multiply ``hi`` exactly and
    ``lo`` cut to TF32; the short sums keep the product within twice the
    f32 product's error at the strip basis's shapes on an H100.
    A thinner ``"high"`` product, and every other name, runs ``a @ b``.
    Each ``"high"`` product adds one to :data:`THREE_PASS` or to
    :data:`THREE_PASS_DECLINED`.
    """
    global THREE_PASS, THREE_PASS_DECLINED
    if precision != "high":
        return a @ b
    if min(a.shape[-2], a.shape[-1], b.shape[-1]) < THREE_PASS_MIN:
        THREE_PASS_DECLINED += 1
        return a @ b
    THREE_PASS += 1
    # imported here: the kernel's module imports this one
    from vivit_tpu_torch.kernels import three_pass

    if a.is_cuda:
        return three_pass.three_pass_cuda(a, b)
    return three_pass.three_pass_plain(a, b)


# f32 contractions longer than this run in blocks of it (:func:`dot_t`)
_K_BLOCK = 1 << 14


def dot_t(a: torch.Tensor, b: torch.Tensor, operand_dtype=None) -> torch.Tensor:
    """``a @ b.T`` with an f32 result.

    ``operand_dtype=torch.bfloat16`` rounds the operands to bf16 first; the
    products of bf16 values are exact in f32 and the sums stay f32, so the
    result is never rounded to bf16.  With ``operand_dtype=None`` the
    operands are promoted to at least f32 (exact for bf16-stored blocks, as
    JAX's promotion is) and multiplied there, the contraction in blocks of
    ``_K_BLOCK`` summed: cuBLAS runs a ``[4608, 589824]`` Gram (3c3d's
    dense0 at N=512) without split-K, one f32 sum over all of K, 3.2e-5 off
    float64 on an H100; blocked, the error stays that of one block.
    """
    if operand_dtype is None:
        dtype = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
        a, b = a.to(dtype), b.to(dtype)
        out = None
        for k0 in range(0, a.shape[1], _K_BLOCK):
            part = a[:, k0:k0 + _K_BLOCK] @ b[:, k0:k0 + _K_BLOCK].T
            out = part if out is None else out + part
        return a @ b.T if out is None else out
    low_a = a.to(operand_dtype)
    low_b = low_a if b is a else b.to(operand_dtype)
    if low_a.is_cuda:
        return torch.mm(low_a, low_b.T, out_dtype=torch.float32)
    # the CPU has no mixed-dtype matmul: the same arithmetic in f32
    return low_a.float() @ low_b.float().T


def gram(flat: torch.Tensor, operand_dtype=None) -> torch.Tensor:
    """``flat @ flat.T`` with an f32 result (:func:`dot_t`)."""
    return dot_t(flat, flat, operand_dtype)


# the K-block of :func:`gram_blocked`: cuBLAS sums each batch item's block
# in one chain on the tensor cores, which truncates, so the error grows with
# the block's length (a Gram's diagonal on an H100, bf16 operands: −5.6e-5
# at 2^14 batched, −5.2e-6 at 2^11, where one product of 2^14 splits its sum
# and errs −3.5e-6), so the blocks are shorter than ``_K_BLOCK``
_BATCHED_K = 1 << 11


def gram_blocked(flat: torch.Tensor, operand_dtype=None, out=None) -> torch.Tensor:
    """``flat @ flat.T`` (:func:`gram`) summed over K-blocks, into ``out``
    when given: the whole blocks of ``_BATCHED_K`` columns through one
    batched product (bf16 operands with f32 results on the card; on the CPU
    the same arithmetic in f32), their f32 results summed, the rest through
    :func:`gram`.  On an H100, at bf16 operands and ``K = 2^28 / n``
    (a token chunk), the batched product takes 0.52 ms at 16 rows and 1.19
    ms at 1152 where a loop of one product a ``_K_BLOCK`` block takes 41.9
    and 1.78 ms (a launch a block leaves the card waiting at few rows), and
    errs less from 128 rows on (5.1e-6 against 2.7e-5 at 1152); its scratch
    is one f32 Gram a block (582 MB at 1152 rows)."""
    k = flat.shape[1]
    whole = k // _BATCHED_K
    if whole:
        blocks = flat[:, :whole * _BATCHED_K].unflatten(1, (whole, _BATCHED_K)).transpose(0, 1)
        if operand_dtype is None:
            dtype = torch.promote_types(flat.dtype, torch.float32)
            blocks = blocks.to(dtype)
            parts = torch.bmm(blocks, blocks.mT)
        else:
            low = blocks.to(operand_dtype)
            parts = (torch.bmm(low, low.mT, out_dtype=torch.float32) if low.is_cuda
                     else torch.bmm(low.float(), low.float().mT))
        g = parts.sum(dim=0)
        out = g if out is None else out.add_(g)
    if whole * _BATCHED_K < k:
        g = gram(flat[:, whole * _BATCHED_K:], operand_dtype)
        out = g if out is None else out.add_(g)
    return out
