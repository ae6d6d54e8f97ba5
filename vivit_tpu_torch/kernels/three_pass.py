"""The three-pass TF32 product of ``eigh_dc``'s large basis products: Hopper
kernel.

:func:`vivit_tpu_torch.precision.matmul` at ``"high"`` runs every product
whose sides (``m``, ``n``, ``k``) all reach ``precision.THREE_PASS_MIN`` as
``lo_a·hi_b + hi_a·lo_b + hi_a·hi_b``: each f32 operand split into ``hi``,
its TF32 rounding to nearest (:func:`vivit_tpu_torch.precision.tf32_split`),
and the exact rest ``lo``.  The JAX package leaves its ``"high"`` products
to XLA (bf16_3x on the TPU), so this kernel stands for no Pallas kernel; it
replaces cuBLAS TF32 passes over split copies of the operands, whose
``hi·hi`` ran in k-chunks of 384 to keep the tensor cores' truncating sums
short.  The CUDA C++ source is ``vivit_tpu_torch/csrc/three_pass.cu``; its
header says what bounds the kernel on an H100 (at 4608³: 587 GFLOP of
TF32, 1.186 ms at 495 TFLOP/s) and what the design does about it.  In
short: 128 × 128 tiles; TMA loads of f32 slabs of both operands, read
in place (a squaring reads one tensor); ``a`` split in registers as
``wgmma``'s register operand, ``b`` split into swizzled ``hi`` and ``lo``
tiles in shared memory; each 32 positions of ``k`` run their three passes
into a fresh accumulator, added to an f32 sum in registers; the output
written once.

Beside it:

* :func:`three_pass_plain`: the same split, three products and f32 sums
  every :data:`PROMOTE` positions in plain PyTorch, on whatever device the
  operands lie: the CPU's route and the reference of the tests and of
  ``chip_smoke.py``;
* :func:`three_pass_cuda`: the kernel's wrapper, which ``precision.matmul``
  calls for CUDA operands.  It checks its inputs (raises off a CUDA card
  with compute capability 9: there is no fallback), hands the kernel the
  operands as they lie where TMA can read them row-major (:func:`_tma_operand`:
  a row-major copy otherwise, as of ``Yᵀ`` in a ``Yᵀ Y``), allocates the
  output, launches on the current stream without synchronising and counts
  the launch in :data:`LAUNCHES`.

The kernel is built with ``nvcc`` for ``sm_90a`` at its first CUDA call and
loaded by :func:`vivit_tpu_torch.kernels.toolchain.load`.  A launch neither
allocates nor reads the host, so it runs inside a CUDA graph once an eager
call has built the library and raised the device's shared-memory limit.
"""

from ctypes import c_int, c_longlong, c_void_p

import torch

from vivit_tpu_torch.kernels import toolchain
from vivit_tpu_torch.precision import tf32_split
from vivit_tpu_torch.utils import graphs

# Launches of the kernel since the last reset (``LAUNCHES = 0``).  A replay
# of captured CUDA graphs makes no Python call: it adds the launches its
# graphs captured (``vivit_tpu_torch.utils.graphs``).
LAUNCHES = 0
graphs.count_launches(__name__)

# the positions of k whose three passes one fresh accumulator sums
PROMOTE = 32

# the C entries of ``csrc/three_pass.cu`` and their arguments
_ENTRIES = {
    "vivit_three_pass_prepare": [],
    "vivit_three_pass_f32": [c_void_p] * 3 + [c_int] * 4 + [c_longlong] * 6 + [c_void_p],
}


def _check(a, b):
    """Raises unless ``a [.., m, k] @ b [.., k, n]`` is an f32 product, 2-D
    or of equal batches, on one device."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"the three-pass product takes float32 operands, got {a.dtype} and "
                        f"{b.dtype}")
    if a.dim() != b.dim() or a.dim() not in (2, 3) or a.shape[-1] != b.shape[-2] or (
            a.dim() == 3 and a.shape[0] != b.shape[0]):
        raise ValueError(f"the three-pass product takes [m, k] @ [k, n] or [b, m, k] @ "
                         f"[b, k, n], got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.numel() == 0 or b.numel() == 0:
        raise ValueError(f"empty operands: {tuple(a.shape)} and {tuple(b.shape)}")


def three_pass_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel forms it: each operand split once
    (:func:`~vivit_tpu_torch.precision.tf32_split`; a squaring splits one
    tensor), ``lo_a·hi_b + hi_a·lo_b + hi_a·hi_b`` of every :data:`PROMOTE`
    positions of ``k`` summed in f32 and added to the output, on whatever
    device the operands lie."""
    _check(a, b)
    hi_b, lo_b = tf32_split(b)
    hi_a, lo_a = (hi_b, lo_b) if a is b else tf32_split(a)
    out = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, a.shape[-1], PROMOTE):
        ah, al = hi_a[..., k0:k0 + PROMOTE], lo_a[..., k0:k0 + PROMOTE]
        bh, bl = hi_b[..., k0:k0 + PROMOTE, :], lo_b[..., k0:k0 + PROMOTE, :]
        out += al @ bh + ah @ bl + ah @ bh
    return out


def _tma_operand(x):
    """The 3-D ``x`` as TMA reads it: row-major, the row pitch and a batch's
    pitch multiples of 16 bytes (a lone batch's pitch unread), the base
    16-byte aligned; as it lies where it is so, else a row-major copy whose
    row pitch is padded to 4 elements."""
    b, r, c = x.shape
    if (x.stride(-1) == 1 and x.stride(-2) % 4 == 0 and x.stride(-2) > 0
            and (b == 1 or (x.stride(0) % 4 == 0 and x.stride(0) > 0))
            and x.data_ptr() % 16 == 0):
        return x
    out = torch.empty((b, r, -(-c // 4) * 4), dtype=x.dtype, device=x.device)[..., :c]
    return out.copy_(x)


def three_pass_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Hopper kernel: :func:`three_pass_plain`'s product, three TF32
    passes on the tensor cores in one launch, into a new f32 tensor, on
    the current stream."""
    global LAUNCHES
    _check(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"the three-pass kernel takes CUDA tensors, got {a.device}")
    if torch.cuda.get_device_capability(a.device)[0] != 9:
        raise ValueError(f"the three-pass kernel needs a Hopper card (sm_90a), got "
                         f"{torch.cuda.get_device_name(a.device)}")
    b3 = _tma_operand(b if b.dim() == 3 else b[None])
    a3 = b3 if a is b else _tma_operand(a if a.dim() == 3 else a[None])
    batch, m, k = a3.shape
    n = b3.shape[-1]
    out = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    lib = toolchain.load("three_pass", _ENTRIES, a.device, "three-pass kernel")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.vivit_three_pass_f32(
            a3.data_ptr(), b3.data_ptr(), out.data_ptr(), batch, m, n, k, *a3.stride(),
            *b3.stride(), stream)
    if err != 0:
        raise RuntimeError("three-pass kernel launch failed: "
                           + (f"tensor map refused, CUresult {err - 10000}" if err >= 10000
                              else f"cudaError {err}"))
    LAUNCHES += 1
    return out if a.dim() == 3 else out[0]

