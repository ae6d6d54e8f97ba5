"""Batched small-matrix symmetric eigendecomposition (port of
``vivit_tpu/kernels/jacobi.py``).

The leaf and window solver of the spectral D&C eigensolver
(:mod:`vivit_tpu_torch.eigdc`), the counterpart of the JAX package's
``_leaf_eigh`` → ``batched_eigh``.  :func:`batched_eigh` dispatches by
:func:`route`, a policy measured on an NVIDIA H100 80GB HBM3 at 700 W, as
the JAX package's dispatcher does by its own measurements on a TPU:

* ``"window"``: f32 ``[b, m, m]`` with ``m`` in {32, 48, 64}, any ``b``
  (:func:`jacobi_supported`): the window kernel, or its plain version on a
  CPU tensor;
* ``"leaf"``: any other f32 ``[b, m, m]`` with ``m <= 160`` on a CUDA
  tensor (:func:`leaf_supported`): the leaf kernel
  (:mod:`vivit_tpu_torch.kernels.jacobi_leaf_cuda`), except a single
  matrix of ``m >= SINGLE_VENDOR_M`` solved outside any CUDA graph;
* ``"vendor"``: everything else, one batched ``torch.linalg.eigh``.

A single matrix (``b == 1``) holds one of the 132 SMs, and alone the leaf
kernel loses to ``torch.linalg.eigh`` from ``m`` about 72 (1.08x at 72,
1.22-2.58x from 80 to 160; H100 80GB HBM3, 700 W,
``tools/torch_eigh_routes.py``).  Inside a captured solve it stays on the
kernel all the same, so that the solve stays whole, with no host read
inside: there the vendor would be an eager step splitting the graphs (at
the N=128 headline that step would save 0.45 ms of 42.8).  The caller says
when its batches are solved outside any graph (:func:`outside_graphs`,
around ``eigh_dc``'s strip path, which no graph captures); there such a
single matrix goes to the vendor.

The window route is a function of shape and dtype alone, so the CPU tests
take the routes the card takes there.  The leaf route is not: a CPU tensor
of its range keeps ``torch.linalg.eigh``.  The plain Jacobi, a loop of
small tensor ops over every step of every sweep, is far slower than LAPACK
on a CPU at these sizes, and the test suite's hundreds of CPU ``eigh_dc``
calls (n from 384 to 1536) would pay that on every leaf.  The tests run
the plain leaf solve directly, and through ``eigh_dc`` with this rule
patched.

On a CUDA tensor a kernel route launches its kernel or raises: nothing
falls back to the vendor.  ``torch.linalg.eigh`` on a CUDA tensor reads
cuSOLVER's status on the host, so inside a captured solve the vendor route
runs as an eager step between two graphs
(:func:`vivit_tpu_torch.utils.graphs.eager`); both kernels run inside them.

The JAX package's third route, a ``lax.map`` of single solves for
multi-batch blocks of m >= 256, has no counterpart: on the H100 a Python
loop of single ``torch.linalg.eigh`` calls was no faster than the batched
call beyond the run-to-run spread at any block measured (0.94-1.15x, m from
96 to 2048; 1.00-1.07x on the paths' own leaves in situ;
``tools/torch_eigh_routes.py``), because torch's batched eigh for m > 32
is already a loop of cuSOLVER's single-matrix solvers.
"""

from contextlib import contextmanager

import torch

from vivit_tpu_torch.kernels.jacobi_cuda import KERNEL_SIZES, batched_eigh_jacobi
from vivit_tpu_torch.kernels.jacobi_leaf_cuda import LEAF_MAX_M, batched_eigh_leaf
from vivit_tpu_torch.utils.graphs import eager as eager_step

# the smallest m at which one matrix solved outside any graph goes to the
# vendor (see the module docstring)
SINGLE_VENDOR_M = 72
_OUTSIDE_GRAPHS = False  # set by outside_graphs()


def jacobi_supported(shape, dtype) -> bool:
    """The window kernel's envelope: f32 ``[b, m, m]`` with ``m`` in
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


def leaf_supported(shape, dtype) -> bool:
    """The leaf kernel's envelope: f32 ``[b, m, m]``, ``1 <= m <= 160``
    (A and V of one matrix in one block's shared memory), any ``b``."""
    if dtype != torch.float32 or len(shape) != 3:
        return False
    b, m, m2 = shape
    return m == m2 and 1 <= m <= LEAF_MAX_M


def route(shape, dtype, device, eager: bool = False) -> str:
    """``"window"``, ``"leaf"`` or ``"vendor"`` for a batch of ``shape`` and
    ``dtype`` on ``device``, solved outside any CUDA graph if ``eager`` (see
    the module docstring)."""
    if jacobi_supported(shape, dtype):
        return "window"
    if torch.device(device).type == "cuda" and leaf_supported(shape, dtype):
        single = shape[0] == 1 and shape[-1] >= SINGLE_VENDOR_M
        return "vendor" if eager and single else "leaf"
    return "vendor"


@contextmanager
def outside_graphs():
    """Inside the block :func:`batched_eigh` routes its batches as solved
    outside any CUDA graph (:func:`route`'s ``eager``)."""
    global _OUTSIDE_GRAPHS
    before, _OUTSIDE_GRAPHS = _OUTSIDE_GRAPHS, True
    try:
        yield
    finally:
        _OUTSIDE_GRAPHS = before


def batched_eigh(A: torch.Tensor):
    """Batched symmetric eigendecomposition: ``[B, m, m] -> (evals [B, m]
    ascending, evecs [B, m, m])``, by :func:`route`."""
    way = route(A.shape, A.dtype, A.device, _OUTSIDE_GRAPHS)
    if way == "window":
        return batched_eigh_jacobi(A.contiguous())
    if way == "leaf":
        return batched_eigh_leaf(A.contiguous())
    return eager_step(torch.linalg.eigh, A)
