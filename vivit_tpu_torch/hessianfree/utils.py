"""Low-rank operators (counterpart of ``vivit_tpu/hessianfree/utils.py``)."""

import numpy as np
import torch


class LowRank:
    """``Σ_i c_i a_i a_iᵀ`` as a linear operator: a matvec is two skinny
    products on the device, ``A (c ⊙ (Aᵀ x))``.  ``c`` and ``A`` are numpy
    arrays or tensors (on any device); ``x`` a numpy vector or a tensor (the
    result is a numpy vector).  The ``@``
    protocol and ``as_scipy()``, as the curvature operators have.  ``device``
    defaults to the CUDA card (``device="cpu"`` runs on the CPU)."""

    def __init__(self, c, A, device=None):
        from vivit_tpu_torch.utils.device import resolve_device

        self._device = resolve_device(device)
        self._A = torch.as_tensor(A, device=self._device)
        self._c = torch.as_tensor(c, dtype=self._A.dtype, device=self._device)
        self.shape = (self._A.shape[0], self._A.shape[0])
        self.dtype = torch.empty(0, dtype=self._A.dtype).numpy().dtype

    def _matvec(self, x) -> np.ndarray:
        x = torch.as_tensor(x, dtype=self._A.dtype, device=self._device).reshape(-1)
        return (self._A @ (self._c * (self._A.T @ x))).cpu().numpy()

    def matvec(self, x):
        return self._matvec(x)

    def __matmul__(self, x):
        return self._matvec(x)

    def as_scipy(self):
        from scipy.sparse.linalg import LinearOperator as ScipyLO

        return ScipyLO(shape=self.shape, dtype=self.dtype, matvec=self._matvec)


class Projector(LowRank):
    """Projector onto the orthonormal columns ``{a_i}`` of ``A``."""

    def __init__(self, A, device=None):
        super().__init__(torch.ones(A.shape[1]), A, device=device)
