"""Matmul precision: the JAX package's precision names in PyTorch terms.

JAX ``"highest"`` is full f32.  PyTorch on a CUDA card runs f32 matmuls in
full f32 by default, but f32 convolutions go through cuDNN in TF32, which
keeps about three decimal digits; :func:`full_f32` turns off both.  JAX
``"high"`` (bf16_3x, ~1e-5 relative) has no PyTorch counterpart finer than
TF32, so it maps to full f32 as well.

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
    ``"high"`` and ``None`` all run in full f32."""
    if precision not in ("highest", "high", None):
        raise ValueError(
            f"precision {precision!r} is not supported by the port "
            "(use 'highest' or 'high'; both run in full f32)"
        )
    return full_f32()


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
