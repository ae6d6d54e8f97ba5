"""Matmul precision: the JAX package's precision names in PyTorch terms.

JAX ``"highest"`` is full f32.  PyTorch on a CUDA card runs f32 matmuls in
full f32 by default, but f32 convolutions go through cuDNN in TF32, which
keeps about three decimal digits; :func:`full_f32` turns off both.  JAX
``"high"`` is bf16_3x, ~1e-5 relative.  Its counterpart here is
:func:`matmul`'s three-pass TF32 product, within twice the f32
product's error on an H100, which
``eigh_dc``'s basis takes at ``"high"`` (its ``basis_prec``,
``deskew_prec`` and ``q_prec``).  As a pipeline-wide name
(:func:`matmul_precision`), ``"high"`` runs in full f32.

``_PRECISIONS`` is the counterpart of the map in
``vivit_tpu/linalg/eigvalsh.py``: a name to the operand dtype of a Gram
contraction (``None`` = full f32).  ``"bf16"`` rounds the operands to bf16
and keeps an f32 result.
"""

import math
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
# passes (:func:`matmul`): below it the f32 product is as fast as the three
# passes, their splits and their chunks.  An H100's crossover for n³
# products lies at 2048 (0.75x at 1536, 0.92x at 1792, 1.07x at 2048, 1.03x
# at 2448, 1.28x at 3072); [2, n, n] batches cross near it and less
# steadily (1.04x at 1536, 0.95x at 2048, 0.94x at 2448, 1.32x at 3072)
THREE_PASS_MIN = 2048
# the longest sum that one TF32 pass of hi·hi takes (:func:`matmul`).  On an
# H100 a TF32 pass's error grows with the sum's length, not its root, as
# rounding toward zero at each step would: three unchunked passes at 4608³
# read 4.5x the f32 product's error against float64 and 8.8x at
# 4608×4608×2400 (whose f32 product reads half the square's).  Each chunk's
# sum is added to the output in f32, so the error falls with the chunk: at
# 384 the three passes read 0.77x the f32 product's at 4608³, 1.54x at
# 4608×4608×2400, 1.04x at 2448³ (random operands), within twice the f32
# product's at every shape of the strip basis
THREE_PASS_CHUNK = 384
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


def _transposed(a, b):
    """Whether ``a`` is a view of ``b`` with its last two axes swapped."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.mT.shape
            and a.stride() == b.mT.stride())


def matmul(a: torch.Tensor, b: torch.Tensor, precision=None) -> torch.Tensor:
    """``a @ b`` of f32 operands at a JAX precision name, the counterpart
    of the JAX package's ``_mm(a, b, prec)`` (``vivit_tpu/eigdc.py``).

    ``"high"`` with every side (``m``, ``n``, ``k``) at least
    :data:`THREE_PASS_MIN` runs as three TF32 products, 2-D or equal-batch
    3-D: each operand split once (``hi`` its TF32 rounding, ``lo`` the exact
    rest: :func:`tf32_split`), ``hi·lo + lo·hi`` first and ``hi·hi`` last, in
    ``k``-chunks of at most :data:`THREE_PASS_CHUNK`, summed in f32 into one
    output (β = 1), with TF32 on around these calls alone.  On the card the tensor cores
    multiply ``hi`` exactly and ``lo`` cut to TF32; the error is that of
    their sums, which the chunks keep within twice the f32 product's error;
    on the CPU the same passes run in f32.
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
    hi_b, lo_b = tf32_split(b)
    if a is b:
        hi_a, lo_a = hi_b, lo_b
    elif _transposed(a, b):
        hi_a, lo_a = hi_b.mT, lo_b.mT
    else:
        hi_a, lo_a = tf32_split(a)
    k = a.shape[-1]
    # as few chunks as the cap allows, each but the last a multiple of 128
    # (cuBLAS runs chunks of 350 well below the speed of chunks of 384)
    step = min(THREE_PASS_CHUNK, -(-math.ceil(k / math.ceil(k / THREE_PASS_CHUNK)) // 128) * 128)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        if a.dim() == 2:
            out = torch.mm(hi_a, lo_b).addmm_(lo_a, hi_b)
            add = out.addmm_
        else:
            out = torch.bmm(hi_a, lo_b).baddbmm_(lo_a, hi_b)
            add = out.baddbmm_
        for k0 in range(0, k, step):
            add(hi_a[..., k0:k0 + step], hi_b[..., k0:k0 + step, :])
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


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
