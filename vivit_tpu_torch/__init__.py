"""vivit_tpu_torch: the PyTorch/CUDA port of ``vivit_tpu``.

Low-rank GGN curvature access on an NVIDIA H100.  Module names mirror the
JAX package's, so each counterpart is easy to find; the JAX package stays the
reference and this package imports none of it.

The port so far covers, for an ``nn.Module`` or a plain model function
``model_fn(params, X)``:

* the reference's computation classes :class:`EigvalshComputation`,
  :class:`EighComputation` (:mod:`~vivit_tpu_torch.linalg`),
  :class:`DirectionalDerivativesComputation` and
  :class:`DirectionalDampedNewtonComputation`, over the generic
  V-transform (:func:`~vivit_tpu_torch.ggn.ggn_sqrt_vt`, any
  differentiable model) or the structured one of a module
  (:mod:`~vivit_tpu_torch.engines`), with exact or Monte-Carlo factors of
  the losses :class:`CrossEntropyLoss`, :class:`MSELoss` and
  :class:`CustomLoss`, and the matrix-free products
  :func:`ggn_vector_product`, :func:`hessian_vector_product` and
  :func:`ggn_mat_prod`;
* :func:`~vivit_tpu_torch.structured.eigvalsh_structured`: tapped
  V-transform (:mod:`~vivit_tpu_torch.tapped`), exact CE loss factors with
  null-space deflation (:mod:`~vivit_tpu_torch.ggn`,
  :mod:`~vivit_tpu_torch.deflate`), the mixed Gram, and the eigensolver
  (:func:`~vivit_tpu_torch.eig.full_eigh`);
* :func:`~vivit_tpu_torch.linalg.eigh.eigh_topk`: top-k eigenpairs with
  Gram-level CE deflation and back-projection to parameter space;
* :func:`~vivit_tpu_torch.structured.newton_step_structured`: the damped
  Newton step along the top-k GGN directions (per-sample gradients
  :func:`~vivit_tpu_torch.ggn.batch_grad`, γ/λ), and
  :mod:`~vivit_tpu_torch.optim` (``newton_step_topk``,
  ``directional_derivatives_topk`` and the two computation classes);
* the streamed memory mode (:mod:`~vivit_tpu_torch.chunked`:
  ``gram_streamed``, ``eigvalsh_streamed``, ``eigh_topk_streamed``,
  ``newton_step_streamed``), at most two factor slices of ``Vᵀ`` alive;
* the matrix-free dataset operators and Lanczos spectral densities
  (:mod:`~vivit_tpu_torch.hessianfree`), the Gram primitives of the
  reference's extension hooks (:mod:`~vivit_tpu_torch.extensions`) and the
  eigenvalue stability helpers of :mod:`~vivit_tpu_torch.eig`;
* :func:`~vivit_tpu_torch.eigdc.eigh_dc`: the spectral divide-and-conquer
  eigensolver (chain and strip paths, both modes) and
  :func:`~vivit_tpu_torch.eigdc.refine_eigh`, whose window solves run the
  hand-written Hopper Jacobi kernel
  (:mod:`~vivit_tpu_torch.kernels.jacobi_cuda`, ``csrc/jacobi.cu``), and
  LOBPCG for the top-k (:mod:`~vivit_tpu_torch.lobpcg`);
* data parallelism over ``torch.distributed``
  (:mod:`~vivit_tpu_torch.parallel`: the batch sharded over the ranks of a
  process group, the Gram assembled with ``all_to_all`` and
  ``all_reduce``; the streamed composition in
  :mod:`~vivit_tpu_torch.parallel.streamed`).

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from vivit_tpu_torch import deflate, extensions, hessianfree, losses, structured
from vivit_tpu_torch.chunked import eigvalsh_streamed, gram_streamed
from vivit_tpu_torch.eig import full_eigh, topk_eigh
from vivit_tpu_torch.eigdc import eigh_dc, eigvalsh_dc, refine_eigh
from vivit_tpu_torch.ggn import (
    batch_grad,
    ggn_mat_prod,
    ggn_sqrt_vt,
    ggn_vector_product,
    hessian_vector_product,
)
from vivit_tpu_torch.linalg.eigh import EighComputation, eigh_topk
from vivit_tpu_torch.linalg.eigvalsh import EigvalshComputation, eigvalsh
from vivit_tpu_torch.linalg.utils import keep_all, keep_nonzero, keep_top_k
from vivit_tpu_torch.losses import CrossEntropyLoss, CustomLoss, Loss, MSELoss
from vivit_tpu_torch.models import CNN3c3d
from vivit_tpu_torch.optim.directional_damped_newton import (
    DirectionalDampedNewtonComputation,
    constant_damping,
    newton_step_topk,
)
from vivit_tpu_torch.optim.directional_derivatives import (
    DirectionalDerivativesComputation,
    directional_derivatives_topk,
)
from vivit_tpu_torch.structured import eigvalsh_structured, newton_step_structured

__version__ = "0.1.0"

__all__ = [
    "CNN3c3d",
    "CrossEntropyLoss",
    "CustomLoss",
    "DirectionalDampedNewtonComputation",
    "DirectionalDerivativesComputation",
    "EighComputation",
    "EigvalshComputation",
    "Loss",
    "MSELoss",
    "batch_grad",
    "constant_damping",
    "deflate",
    "directional_derivatives_topk",
    "eigh_dc",
    "eigh_topk",
    "eigvalsh",
    "eigvalsh_dc",
    "eigvalsh_streamed",
    "eigvalsh_structured",
    "extensions",
    "full_eigh",
    "ggn_mat_prod",
    "ggn_sqrt_vt",
    "ggn_vector_product",
    "gram_streamed",
    "hessian_vector_product",
    "hessianfree",
    "keep_all",
    "keep_nonzero",
    "keep_top_k",
    "losses",
    "newton_step_structured",
    "newton_step_topk",
    "refine_eigh",
    "structured",
    "topk_eigh",
]
