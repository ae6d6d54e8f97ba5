"""Batched small-matrix symmetric eigendecomposition (counterpart of
``vivit_tpu/kernels/jacobi.py``).

The leaf and window solver of the spectral D&C eigensolver
(:mod:`vivit_tpu_torch.eigdc`).  :func:`batched_eigh` sends the shapes that
the JAX package sends to its Pallas Jacobi kernel (the same envelope as
``jacobi_pallas.jacobi_supported``) to the hand-written Jacobi kernel, and
everything else to ``torch.linalg.eigh``.  The envelope was measured on a
TPU; ``chip_smoke.py``'s shape sweep times both solvers over it on the
H100, and choosing the H100's own envelope is open work (ROADMAP).
"""

import torch

from vivit_tpu_torch.kernels.jacobi_cuda import batched_eigh_jacobi


def jacobi_supported(shape, dtype) -> bool:
    """The window envelope: f32, 3-D, ``m % 16 == 0``, ``32 <= m <= 64``,
    ``b·m <= 2048``."""
    if dtype != torch.float32 or len(shape) != 3:
        return False
    b, m, m2 = shape
    return m == m2 and m % 16 == 0 and 32 <= m <= 64 and b * m <= 2048


def batched_eigh(A: torch.Tensor):
    """Batched symmetric eigendecomposition (ascending eigenvalues).

    Inside the envelope a CUDA tensor launches the Jacobi kernel and a CPU
    tensor runs its plain version; outside it, ``torch.linalg.eigh``.
    """
    if jacobi_supported(A.shape, A.dtype):
        return batched_eigh_jacobi(A.contiguous())
    return torch.linalg.eigh(A)
