"""Batched small-matrix symmetric eigendecomposition (port of
``vivit_tpu/kernels/jacobi.py``).

The leaf and window solver of the spectral D&C eigensolver
(:mod:`vivit_tpu_torch.eigdc`).  :func:`batched_eigh` dispatches by a
policy measured on an NVIDIA H100 80GB HBM3 at 700 W, as the JAX package's
dispatcher does by its own measurements on a TPU: the hand-written Jacobi
kernel inside :func:`jacobi_supported` (its plain version on a CPU
tensor), one batched ``torch.linalg.eigh`` else.  The policy is a function
of shape and dtype alone, so the CPU tests take the routes the card takes.

The JAX package's third route, a ``lax.map`` of single solves for
multi-batch blocks of m >= 256, has no counterpart: on the H100 a Python
loop of single ``torch.linalg.eigh`` calls was no faster than the batched
call beyond the run-to-run spread at any block measured (0.94-1.15x, m from
96 to 2048; 1.00-1.07x on the paths' own leaves in situ;
``tools/torch_eigh_routes.py``), because torch's batched eigh for m > 32
is already a loop of cuSOLVER's single-matrix solvers.

``torch.linalg.eigh`` on a CUDA tensor reads cuSOLVER's status on the host,
so inside a captured solve it runs as an eager step between two graphs
(:func:`vivit_tpu_torch.utils.graphs.eager`); the kernel runs inside them.
"""

import torch

from vivit_tpu_torch.kernels.jacobi_cuda import KERNEL_SIZES, batched_eigh_jacobi
from vivit_tpu_torch.utils.graphs import eager


def jacobi_supported(shape, dtype) -> bool:
    """The kernel's envelope: f32 ``[b, m, m]`` with ``m`` in
    :data:`KERNEL_SIZES`, any ``b``.

    On an H100 80GB HBM3 at 700 W the kernel beat ``torch.linalg.eigh`` at
    every shape of ``chip_smoke.py``'s shape sweep (b from 1 to 438, m in
    {32, 48, 64}) and of ``tools/torch_eigh_routes.py``'s (b to 4096): the
    kernel grows by waves of the 132 SMs, eigh by a matrix at a time for
    m > 32 (about 0.8 ms each at m=64); at m=32, where eigh is cuSOLVER's
    batched Jacobi, the kernel took 0.65-0.86 of its time from b=8 to 4096.
    The TPU's ``b·m <= 2048`` does not hold on the H100.
    """
    if dtype != torch.float32 or len(shape) != 3:
        return False
    b, m, m2 = shape
    return m == m2 and m in KERNEL_SIZES


def batched_eigh(A: torch.Tensor):
    """Batched symmetric eigendecomposition: ``[B, m, m] -> (evals [B, m]
    ascending, evecs [B, m, m])``.

    Inside the envelope a CUDA tensor launches the Jacobi kernel and a CPU
    tensor runs its plain version; outside it, ``torch.linalg.eigh``.
    """
    if jacobi_supported(A.shape, A.dtype):
        return batched_eigh_jacobi(A.contiguous())
    return eager(torch.linalg.eigh, A)
