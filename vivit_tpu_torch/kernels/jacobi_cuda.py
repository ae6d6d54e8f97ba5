"""Batched symmetric eigendecomposition by cyclic Jacobi: Hopper kernel.

Counterpart of ``vivit_tpu/kernels/jacobi_pallas.py`` (``batched_eigh_jacobi``).
The CUDA C++ source is ``vivit_tpu_torch/csrc/jacobi.cu``; its header says
what bounds it on an H100 and what the design does about it.

Three pieces, one function:

* :func:`batched_eigh_jacobi_plain`: the plain PyTorch version (batched
  tensor ops, the same round-robin ordering, rotation formulas and exit
  rule as the kernel).  The CPU tests run it, and ``chip_smoke.py`` holds
  the kernel against it on the card.
* :func:`batched_eigh_jacobi_cuda`: the kernel's wrapper.  Checks its input,
  allocates the outputs, launches on the current stream without
  synchronising, and counts the launch in :data:`LAUNCHES`.
* :func:`batched_eigh_jacobi`: a CPU tensor goes to the plain version, a
  CUDA tensor to the kernel.  There is no fallback between the two.

Both run at most ``sweeps`` sweeps (:data:`SWEEPS` by default, as the TPU
kernel's ``sweeps=12``) and stop a matrix after the first sweep in which
every rotation was the identity (``|a_pq| <= 1e-30``): every later sweep
would leave it exactly as it is, so the result is that of ``sweeps``
sweeps.  The kernel always exits so; the plain version does when asked
(``exit_early``).  The round-robin order of the pairs is not the TPU
kernel's odd-even order, so before both have converged their results
differ.

Kernel and plain version apply the same operations in the same order and
rounding, so on the card they agree to the bit on the inputs that
``chip_smoke.py`` checks.

The kernel is built with ``nvcc`` for ``sm_90a`` at its first CUDA call, into
``vivit_tpu_torch/_build/``, and loaded with ``ctypes``.
"""

import hashlib
import os
import time

import torch

SWEEPS = 12
MAX_M = 64
# the sizes the kernel is compiled for: the dispatch envelope's m
KERNEL_SIZES = (32, 48, 64)

# Launches of the CUDA kernel since the last reset (``LAUNCHES = 0``).  A
# replay of captured CUDA graphs makes no Python call: it adds the launches
# its graphs captured (``vivit_tpu_torch.utils.graphs``).
LAUNCHES = 0

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB = None
_SCHEDULES = {}  # (m, device) -> the schedule table on that device
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no multiply-add contraction: the kernel rounds every product and sum
    # as its plain version does
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _rot_from(app, aqq, apq):
    """Jacobi rotation ``(c, s, t)`` that annihilates ``apq`` (``t = s/c``).

    The formulas of the TPU kernel's ``_rot_from``: ``tau == 0`` takes the
    45-degree rotation (copysign, not ``sign(0) = 0``), and ``|apq| <= 1e-30``
    takes the identity.
    """
    small = apq.abs() <= 1e-30
    tau = (aqq - app) / torch.where(small, torch.ones_like(apq), 2.0 * apq)
    sign = torch.where(tau >= 0.0, 1.0, -1.0)
    t = sign / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c, t


def round_robin_pairs(m: int):
    """``(p, q)`` index tensors ``[m-1, m/2]`` of one sweep, ``p < q``.

    Position 0 holds index 0; positions ``1..m-1`` hold the other indices
    rotated by the step; pair ``k`` joins positions ``k`` and ``m-1-k``
    (the kernel's ``player``).
    """
    steps = torch.arange(m - 1)[:, None]
    pos = torch.arange(m)[None, :]
    players = torch.where(pos == 0, 0, (pos - 1 + steps) % (m - 1) + 1)
    h = m // 2
    x = players[:, :h]
    y = players.flip(1)[:, :h]
    return torch.minimum(x, y), torch.maximum(x, y)


def schedule_table(m: int) -> torch.Tensor:
    """The kernel's schedule, int32 ``[m-1, m/2]``: pair ``j`` of step ``r``
    of :func:`round_robin_pairs` as ``p | q << 8``, and in bits 16-27 where
    the next step's pair ``j`` ``(p', q')`` lies in step ``r``'s blocks:
    ``kr | a << 5 | kc << 6 | b << 11``, with ``p'`` on side ``a`` (0 for
    ``p``, 1 for ``q``) of pair ``kr`` and ``q'`` on side ``b`` of pair
    ``kc``.  The step after the last is step 0 of the next sweep."""
    P, Q = round_robin_pairs(m)
    steps, h = P.shape
    r = torch.arange(steps)[:, None]
    pair_of = torch.empty((steps, m), dtype=torch.long)
    side = torch.empty((steps, m), dtype=torch.long)
    pair_of[r, P] = torch.arange(h)
    pair_of[r, Q] = torch.arange(h)
    side[r, P] = 0
    side[r, Q] = 1
    Pn, Qn = P.roll(-1, 0), Q.roll(-1, 0)
    ahead = (pair_of.gather(1, Pn) | side.gather(1, Pn) << 5
             | pair_of.gather(1, Qn) << 6 | side.gather(1, Qn) << 11)
    return (P | Q << 8 | ahead << 16).to(torch.int32).contiguous()


def _sort(d, V):
    evals, order = torch.sort(d, dim=-1)
    evecs = torch.gather(V, -1, order[:, None, :].expand_as(V))
    return evals, evecs


def _check_sweeps(sweeps):
    if not isinstance(sweeps, int) or sweeps < 1:
        raise ValueError(f"batched Jacobi runs at least one sweep, got sweeps={sweeps!r}")


def _check_shape(A, max_m=MAX_M):
    if A.dtype != torch.float32:
        raise TypeError(f"batched Jacobi takes float32, got {A.dtype}")
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"batched Jacobi takes [B, m, m], got {tuple(A.shape)}")
    m = A.shape[-1]
    if m < 2 or m > max_m or m % 2:
        raise ValueError(f"batched Jacobi takes even 2 <= m <= {max_m}, got {m}")


def batched_eigh_jacobi_plain(A: torch.Tensor, exit_early: bool = False,
                              return_sweeps: bool = False, sweeps: int = SWEEPS):
    """Plain PyTorch Jacobi: ``[B, m, m] -> (evals [B, m] ascending,
    evecs [B, m, m])`` after ``sweeps`` sweeps, on whatever device ``A``
    lies.

    ``exit_early`` stops once every matrix has had a sweep in which every
    rotation was the identity, as the kernel does; the result is the same.
    ``return_sweeps`` adds the sweeps that rule runs for each matrix (int32
    ``[B]``, at most ``sweeps``), with or without ``exit_early``.
    """
    d, V, ran = jacobi_sweeps_plain(A, exit_early, sweeps)
    evals, evecs = _sort(d, V)
    return (evals, evecs, ran) if return_sweeps else (evals, evecs)


def jacobi_sweeps_plain(A: torch.Tensor, exit_early: bool = False, sweeps: int = SWEEPS,
                        max_m: int = MAX_M):
    """The sweeps of :func:`batched_eigh_jacobi_plain` before the sort:
    ``(diagonal [B, m], V [B, m, m], sweeps run [B])`` for even
    ``m <= max_m`` (the leaf route passes its own bound)."""
    _check_shape(A, max_m)
    _check_sweeps(sweeps)
    b, m, _ = A.shape
    A = 0.5 * (A + A.transpose(-1, -2))
    V = torch.eye(m, dtype=A.dtype, device=A.device).expand(b, m, m).clone()
    P, Q = round_robin_pairs(m)
    P, Q = P.to(A.device), Q.to(A.device)
    ran = torch.full((b,), sweeps, dtype=torch.int32, device=A.device)
    for sweep in range(sweeps):
        rotated = torch.zeros(b, dtype=torch.bool, device=A.device)
        for step in range(m - 1):
            p, q = P[step], Q[step]
            app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]  # [b, h]
            c, s, t = _rot_from(app, aqq, apq)
            rotated |= ~(apq.abs() <= 1e-30).all(dim=1)
            # rows: A <- J^T A
            cr, sr = c[:, :, None], s[:, :, None]
            xp, xq = A[:, p, :], A[:, q, :]
            A[:, p, :] = cr * xp - sr * xq
            A[:, q, :] = sr * xp + cr * xq
            # columns: A <- A J, V <- V J
            cc, sc = c[:, None, :], s[:, None, :]
            for M in (A, V):
                xp, xq = M[:, :, p], M[:, :, q]
                M[:, :, p] = cc * xp - sc * xq
                M[:, :, q] = sc * xp + cc * xq
            # the pivot block in Rutishauser's form: the diagonal moves by
            # ∓t·apq and never goes through (c, s), whose c² + s² ≠ 1 by an
            # ulp would otherwise drift it over hundreds of steps
            A[:, p, p] = app - t * apq
            A[:, q, q] = aqq + t * apq
            A[:, p, q] = 0.0
            A[:, q, p] = 0.0
        # the first sweep without a rotation is the last one the rule runs
        ran = torch.where(~rotated & (ran == sweeps), sweep + 1, ran)
        if exit_early and bool((ran < sweeps).all()):
            break
    return torch.diagonal(A, dim1=-2, dim2=-1), V, ran


def build(name: str = "jacobi"):
    """Compile ``csrc/<name>.cu`` (this module's kernel, or ``jacobi_leaf``
    for :mod:`vivit_tpu_torch.kernels.jacobi_leaf_cuda`) for ``sm_90a``, once
    per version of the source and flags, and return ``(library path,
    seconds, compiler output)``."""
    import subprocess

    source = os.path.join(_PKG_DIR, "csrc", f"{name}.cu")
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_NVCC_FLAGS).encode())
    lib_path = os.path.join(_BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib_path):
        return lib_path, 0.0, ""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(cuda_home, "bin", "nvcc")
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [nvcc, *_NVCC_FLAGS, "-o", tmp, source]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, seconds, proc.stderr


def _library():
    global _LIB
    if _LIB is None:
        import ctypes

        lib_path, _, _ = build()
        lib = ctypes.CDLL(lib_path)
        fn = lib.vivit_jacobi_eigh_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _schedule(m: int, device: torch.device) -> torch.Tensor:
    key = (m, device)
    if key not in _SCHEDULES:
        _SCHEDULES[key] = schedule_table(m).to(device)
    return _SCHEDULES[key]


def batched_eigh_jacobi_cuda(A: torch.Tensor, return_sweeps: bool = False,
                             sweeps: int = SWEEPS):
    """The Hopper kernel: ``[B, m, m] -> (evals ascending, evecs)`` after at
    most ``sweeps`` sweeps, with ``m`` in :data:`KERNEL_SIZES`.
    ``return_sweeps`` adds the sweeps each matrix ran (int32 ``[B]``, on the
    card, not synchronised)."""
    global LAUNCHES
    _check_shape(A)
    _check_sweeps(sweeps)
    b, m, _ = A.shape
    if m not in KERNEL_SIZES:
        raise ValueError(f"the Jacobi kernel is compiled for m = 32, 48 or 64, got {m}")
    if A.device.type != "cuda":
        raise ValueError(f"the Jacobi kernel takes a CUDA tensor, got {A.device}")
    if not A.is_contiguous():
        raise ValueError("the Jacobi kernel takes a contiguous tensor")
    d = torch.empty((b, m), dtype=A.dtype, device=A.device)
    V = torch.empty((b, m, m), dtype=A.dtype, device=A.device)
    sweeps_run = torch.empty((b,), dtype=torch.int32, device=A.device)
    if b > 0:
        fn = _library().vivit_jacobi_eigh_f32
        sched = _schedule(m, A.device)
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream(A.device).cuda_stream
            err = fn(A.data_ptr(), sched.data_ptr(), d.data_ptr(), V.data_ptr(),
                     sweeps_run.data_ptr(), b, m, sweeps, stream)
        if err != 0:
            raise RuntimeError(f"Jacobi kernel launch failed: cudaError {err}")
        LAUNCHES += 1
    evals, evecs = _sort(d, V)
    return (evals, evecs, sweeps_run) if return_sweeps else (evals, evecs)


def batched_eigh_jacobi(A: torch.Tensor, sweeps: int = SWEEPS):
    """``[B, m, m] -> (evals [B, m] ascending, evecs [B, m, m])`` after at
    most ``sweeps`` sweeps.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (or raises).
    """
    if A.device.type == "cpu":
        return batched_eigh_jacobi_plain(A, sweeps=sweeps)
    return batched_eigh_jacobi_cuda(A, sweeps=sweeps)


def rotation_flops(m: int, matrix_sweeps: int) -> int:
    """Floating-point operations of ``matrix_sweeps`` sweeps of an ``m × m``
    matrix (the sweeps run, summed over the batch): per pair and step, 3 per
    updated element of two rows of ``A`` and two columns of ``V`` (12·m),
    plus ~20 for ``(c, s)`` and the pivot block.  ``JᵀAJ`` is symmetric, so
    the two columns of ``A`` mirror its two rows and cost nothing more."""
    return matrix_sweeps * (m - 1) * (m // 2) * (12 * m + 20)


def io_bytes(b: int, m: int) -> int:
    """Bytes one call must move: ``A`` read once, evals, evecs and the
    sweep counts written."""
    return 4 * (b * m * m + b * m + b * m * m + b)


def bound_ms(b: int, m: int, matrix_sweeps: int, peak_flops: float,
             peak_bytes: float):
    """Least time on a card with the given peaks, and what sets it."""
    t_ops = rotation_flops(m, matrix_sweeps) / peak_flops * 1e3
    t_bytes = io_bytes(b, m) / peak_bytes * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
