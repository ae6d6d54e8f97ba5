"""Batched Jacobi eigendecomposition of the leaf and edge blocks of
:mod:`vivit_tpu_torch.eigdc` (f32 ``[B, m, m]``, ``m <= 160``): Hopper kernel.

The JAX package solves these blocks with ``_leaf_eigh``
(``vivit_tpu/eigdc.py``), which at these sizes is ``jnp.linalg.eigh`` inside
the solve's one compiled program.  On the card the vendor's eigh reads
cuSOLVER's status on the host and splits a CUDA graph; this kernel, CUDA
C++ in ``vivit_tpu_torch/csrc/jacobi_leaf.cu`` (its header says what bounds
it on an H100 and what the design does about it), runs inside one.

It computes the function of the window kernel's plain version
(:func:`vivit_tpu_torch.kernels.jacobi_cuda.batched_eigh_jacobi_plain`: the
same round-robin ordering, rotation formulas, exit rule and ``sweeps``) at
any ``m`` up to :data:`LEAF_MAX_M`:

* :func:`batched_eigh_leaf_plain`: that plain version, its size bound
  widened to :data:`LEAF_MAX_M` (the CPU tests run it; ``chip_smoke.py``
  holds the kernel against it on the card, bit for bit);
* :func:`batched_eigh_leaf_cuda`: the kernel's wrapper.  Checks its input,
  allocates the outputs, launches on the current stream without
  synchronising, and counts the launch in :data:`LAUNCHES`;
* :func:`batched_eigh_leaf`: a CPU tensor goes to the plain version, a
  CUDA tensor to the kernel.  There is no fallback between the two.

An odd ``m`` is padded to ``m + 1`` by a zero row and column: every rotation
that touches the pad has ``a_pq = 0`` exactly and is the identity, so the
pad stays decoupled, and its row, column and eigenvalue are dropped before
the sort.  Both versions see the padded input.

The kernel is built by :func:`vivit_tpu_torch.kernels.jacobi_cuda.build`
(``build("jacobi_leaf")``: ``nvcc``, ``sm_90a``, ``--fmad=false``) at its
first CUDA call and loaded with ``ctypes``.
"""

import torch

from vivit_tpu_torch.kernels import jacobi_cuda

LEAF_MAX_M = 160
SWEEPS = jacobi_cuda.SWEEPS

# Launches of the leaf kernel since the last reset (``LAUNCHES = 0``).  A
# replay of captured CUDA graphs makes no Python call: it adds the launches
# its graphs captured (``vivit_tpu_torch.utils.graphs``).
LAUNCHES = 0

_LIB = None
_PREPARED = set()  # devices whose shared-memory limit the library has raised


def _check(A):
    if A.dtype != torch.float32:
        raise TypeError(f"the leaf Jacobi takes float32, got {A.dtype}")
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"the leaf Jacobi takes [B, m, m], got {tuple(A.shape)}")
    m = A.shape[-1]
    if m < 1 or m > LEAF_MAX_M:
        raise ValueError(f"the leaf Jacobi takes 1 <= m <= {LEAF_MAX_M}, got {m}")


def _padded(A):
    """``A`` with a zero row and column appended where ``m`` is odd."""
    return torch.nn.functional.pad(A, (0, 1, 0, 1)) if A.shape[-1] % 2 else A


def _dropped(d, V, m):
    """The pad's row, column and eigenvalue dropped, then sorted."""
    return jacobi_cuda._sort(d[:, :m], V[:, :m, :m])


def batched_eigh_leaf_plain(A: torch.Tensor, exit_early: bool = False,
                            return_sweeps: bool = False, sweeps: int = SWEEPS):
    """Plain PyTorch leaf Jacobi: ``[B, m, m] -> (evals [B, m] ascending,
    evecs [B, m, m])``, ``1 <= m <= 160``, on whatever device ``A`` lies;
    ``exit_early`` and ``return_sweeps`` as in
    :func:`~vivit_tpu_torch.kernels.jacobi_cuda.batched_eigh_jacobi_plain`."""
    _check(A)
    m = A.shape[-1]
    d, V, ran = jacobi_cuda.jacobi_sweeps_plain(_padded(A), exit_early, sweeps,
                                                max_m=LEAF_MAX_M)
    evals, evecs = _dropped(d, V, m)
    return (evals, evecs, ran) if return_sweeps else (evals, evecs)


def _library(device):
    global _LIB
    if _LIB is None:
        import ctypes

        lib_path, _, _ = jacobi_cuda.build("jacobi_leaf")
        lib = ctypes.CDLL(lib_path)
        lib.vivit_jacobi_leaf_prepare.argtypes = []
        lib.vivit_jacobi_leaf_prepare.restype = ctypes.c_int
        fn = lib.vivit_jacobi_leaf_eigh_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    if device not in _PREPARED:
        # the limit belongs to the device's context: raised once per device,
        # at its first launch (an eager warm-up precedes every capture)
        with torch.cuda.device(device):
            err = _LIB.vivit_jacobi_leaf_prepare()
        if err != 0:
            raise RuntimeError(f"leaf Jacobi kernel: shared memory limit refused: cudaError {err}")
        _PREPARED.add(device)
    return _LIB


def batched_eigh_leaf_cuda(A: torch.Tensor, return_sweeps: bool = False,
                           sweeps: int = SWEEPS):
    """The Hopper kernel: ``[B, m, m] -> (evals ascending, evecs)`` after at
    most ``sweeps`` sweeps, ``1 <= m <= 160``.  ``return_sweeps`` adds the
    sweeps each matrix ran (int32 ``[B]``, on the card, not synchronised)."""
    global LAUNCHES
    _check(A)
    jacobi_cuda._check_sweeps(sweeps)
    if A.device.type != "cuda":
        raise ValueError(f"the leaf Jacobi kernel takes a CUDA tensor, got {A.device}")
    if not A.is_contiguous():
        raise ValueError("the leaf Jacobi kernel takes a contiguous tensor")
    b, m = A.shape[0], A.shape[-1]
    Ap = _padded(A)
    mp = Ap.shape[-1]
    d = torch.empty((b, mp), dtype=A.dtype, device=A.device)
    V = torch.empty((b, mp, mp), dtype=A.dtype, device=A.device)
    sweeps_run = torch.empty((b,), dtype=torch.int32, device=A.device)
    if b > 0:
        fn = _library(A.device).vivit_jacobi_leaf_eigh_f32
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream(A.device).cuda_stream
            err = fn(Ap.data_ptr(), d.data_ptr(), V.data_ptr(), sweeps_run.data_ptr(),
                     b, mp, sweeps, stream)
        if err != 0:
            raise RuntimeError(f"leaf Jacobi kernel launch failed: cudaError {err}")
        LAUNCHES += 1
    evals, evecs = _dropped(d, V, m)
    return (evals, evecs, sweeps_run) if return_sweeps else (evals, evecs)


def batched_eigh_leaf(A: torch.Tensor):
    """``[B, m, m] -> (evals [B, m] ascending, evecs [B, m, m])`` after at
    most :data:`SWEEPS` sweeps.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (or raises).
    """
    if A.device.type == "cpu":
        return batched_eigh_leaf_plain(A)
    return batched_eigh_leaf_cuda(A)
