"""The columns of a token block's ``Vᵀ`` on the tensor cores: Hopper kernel.

A token block (:class:`vivit_tpu_torch.structured.TokenFactor`) keeps a
Linear weight's ``Vᵀ`` factored as its inputs ``z [S, T, in]`` and scaled
output cotangents ``δ [CF, S, T, out]``; column ``(c, n)`` is
``Σ_p δ[c, n, p, :] ⊗ z[n, p, :]``.  Before their Gram the columns are
formed in f32, a chunk of rows ``o0:o1`` and columns ``i0:i1`` of the
weight at a time (and rounded to the Gram's operand dtype).  The JAX package has no token factor,
so this kernel stands for no Pallas kernel: it replaces the f32 batched
product (``torch.bmm`` over ``CF`` copies of ``z``) that runs on the SIMT
units, whose peak on an H100 is 67 TFLOP/s.  The CUDA C++ source is
``vivit_tpu_torch/csrc/token_expand.cu``; its header says what bounds the
kernel on an H100 (at ViT-S/16, N=128: 28.9 TFLOP of TF32 a query, 58.4 ms
at 495 TFLOP/s; 136 GB, 40.5 ms at 3.35 TB/s) and what the design does
about it.  In short: a block holds ``z[n, :, i-range]`` in shared memory
and streams ``δ[c, n]`` past it, both read in place; each f32 value is
split in registers into ``hi``, its TF32 rounding to nearest (as
:func:`vivit_tpu_torch.precision.tf32_split`), and the exact ``lo = x −
hi``; ``lo·hi``, ``hi·lo`` and ``hi·hi`` run on the tensor cores
(``mma.sync`` at TF32), each step of 32 positions into a fresh
accumulator added to the f32 sum in registers; the chunk is written once.
The tensor cores multiply ``hi`` exactly and ``lo`` cut to TF32, so the
columns keep an f32 product's error (``lo·lo`` lies below it), where one
TF32 pass keeps ~1e-3.

Beside it:

* :func:`token_expand_plain`: the same split and three products in f32,
  the reference of the tests and of ``chip_smoke.py`` (which holds the
  kernel against it and float64 on the card);
* :func:`token_expand_cuda`: the kernel's wrapper, which
  ``TokenFactor.gram`` calls for f32 factors off the CPU (the CPU keeps
  ``TokenFactor.expand``).  Checks its inputs (raises off a CUDA card:
  there is no fallback), allocates the chunk, launches on the current
  stream without synchronising (once, or once per range of positions where
  ``T`` rows of ``z`` do not fit a block's shared memory), and counts each
  launch in :data:`LAUNCHES`;
* :func:`bf16_apart`: the elements whose bf16 roundings are neither equal
  nor neighbours, the check the tests and ``chip_smoke.py`` make of the
  kernel's columns against the f32 ``bmm``'s.

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

# the C entries of ``csrc/token_expand.cu`` and their arguments
_ENTRIES = {
    "vivit_token_expand_prepare": [],
    "vivit_token_expand_max_rows": [c_int],
    "vivit_token_expand_f32": ([c_void_p] * 3 + [c_int] * 5 + [c_longlong] * 7
                               + [c_int] * 3 + [c_void_p]),
}


def _sliced(z, delta, o0, o1, i0, i1):
    """``(δ[..., o0:o1], z[..., i0:i1])`` after checking the factors."""
    if z.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"the token expansion takes float32 factors, got {z.dtype} "
                        f"and {delta.dtype}")
    if z.dim() != 3 or delta.dim() != 4 or delta.shape[1:3] != z.shape[:2]:
        raise ValueError(f"the token expansion takes z [S, T, in] and δ [CF, S, T, out], "
                         f"got {tuple(z.shape)} and {tuple(delta.shape)}")
    if z.device != delta.device:
        raise ValueError(f"z on {z.device}, δ on {delta.device}")
    d, zc = delta[..., o0:o1], z[..., i0:i1]
    if d.numel() == 0 or zc.numel() == 0:
        raise ValueError(f"empty factors or chunk: δ {tuple(d.shape)}, z {tuple(zc.shape)}")
    return d, zc


def token_expand_plain(z: torch.Tensor, delta: torch.Tensor, o0=0, o1=None, i0=0,
                       i1=None) -> torch.Tensor:
    """The columns ``[CF·S, o1-o0, i1-i0]`` of the weight's rows ``o0:o1``
    and columns ``i0:i1``, as the kernel forms them: each factor split
    (:func:`~vivit_tpu_torch.precision.tf32_split`), ``lo·hi + hi·lo +
    hi·hi`` summed over the positions in f32, on whatever device the
    factors lie."""
    d, zc = _sliced(z, delta, o0, o1, i0, i1)
    (d_hi, d_lo), (z_hi, z_lo) = tf32_split(d), tf32_split(zc)
    out = torch.einsum("cnpo,npi->cnoi", d_lo, z_hi)
    out += torch.einsum("cnpo,npi->cnoi", d_hi, z_lo)
    out += torch.einsum("cnpo,npi->cnoi", d_hi, z_hi)
    return out.reshape(-1, *out.shape[2:])


def _width(ic):
    """The columns ``i`` a block takes: of 192 and 128 the width whose
    blocks cover ``ic`` with the fewest padded columns, the wider of equals."""
    return min((192, 128), key=lambda w: (-(-ic // w) * w, -w))


def _vectorized(d, zc):
    """Whether the kernel may copy 16 bytes at a time: unit inner strides,
    widths and the other strides multiples of 4, 16-byte aligned bases."""
    strides = d.stride()[:-1] + zc.stride()[:-1]
    return (d.stride(-1) == 1 and zc.stride(-1) == 1 and all(x % 4 == 0 for x in strides)
            and d.shape[-1] % 4 == 0 and zc.shape[-1] % 4 == 0
            and d.data_ptr() % 16 == 0 and zc.data_ptr() % 16 == 0)


def token_expand_cuda(z: torch.Tensor, delta: torch.Tensor, o0=0, o1=None, i0=0,
                      i1=None) -> torch.Tensor:
    """The Hopper kernel: the columns ``[CF·S, o1-o0, i1-i0]`` of
    :func:`token_expand_plain`, three TF32 passes on the tensor cores, into
    a new f32 tensor, on the current stream."""
    global LAUNCHES
    d, zc = _sliced(z, delta, o0, o1, i0, i1)
    if d.device.type != "cuda":
        raise ValueError(f"the token expansion kernel takes CUDA tensors, got {d.device}")
    cf, s, t, oc = d.shape
    ic = zc.shape[-1]
    out = torch.empty((cf * s, oc, ic), dtype=torch.float32, device=d.device)
    lib = toolchain.load("token_expand", _ENTRIES, d.device, "token expansion kernel")
    width = _width(ic)
    rows = lib.vivit_token_expand_max_rows(width)
    vec = int(_vectorized(d, zc))
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        for k0 in range(0, t, rows):
            err = lib.vivit_token_expand_f32(
                d[:, :, k0:].data_ptr(), zc[:, k0:].data_ptr(), out.data_ptr(), cf, s,
                min(rows, t - k0), oc, ic, *d.stride(), *zc.stride(), width, int(k0 > 0), vec,
                stream)
            if err != 0:
                raise RuntimeError(f"token expansion kernel launch failed: cudaError {err}")
            LAUNCHES += 1
    return out


def bf16_apart(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The magnitudes (the larger of ``x``'s and ``y``'s, float64) of the
    elements whose bf16 roundings are neither equal nor neighbours."""

    def ordinal(v):
        bits = v.to(torch.bfloat16).view(torch.int16).int()
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))

    apart = (ordinal(x) - ordinal(y)).abs() > 1
    return torch.maximum(x.abs().double(), y.abs().double())[apart]
