"""The spectral divide-and-conquer eigensolver and the streamed memory mode
with the PyTorch port (the twin of ``examples/example_fast_eigensolver.py``).

* ``eig_backend="dc"`` sends the NC×NC Gram eigendecomposition through
  :mod:`vivit_tpu_torch.eigdc`, a divide-and-conquer of matmuls (de-skew
  spectral map, KPM count-balanced sign splits, Davies-Modi and windowed
  Jacobi polish, the windows on a hand-written CUDA kernel on the card);
* ``eigvalsh_streamed`` trades recompute for peak memory, two factor slices
  of ``Vᵀ`` alive instead of all of it.

Runs on the CUDA card when there is one, else on the CPU.
"""

import numpy as np
import torch

import vivit_tpu_torch as vtt
from vivit_tpu_torch.eigdc import eigh_dc
from vivit_tpu_torch.models import MLP

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"
N, D_IN, C = 64, 12, 6

rng = np.random.default_rng(0)
X = rng.normal(size=(N, D_IN)).astype(np.float32)
y = rng.integers(0, C, size=(N,))

torch.manual_seed(0)
model = MLP(D_IN, (48, C)).to(DEVICE)
loss = vtt.CrossEntropyLoss("mean")

# 1) the vendor eigensolver and the D&C backend: the same spectrum
(evals_xla,) = vtt.eigvalsh(model, loss, X, y, device=DEVICE)
(evals_dc,) = vtt.eigvalsh(model, loss, X, y, eig_backend="dc", device=DEVICE)
dev = float((evals_dc - evals_xla).abs().max())
print(f"dc-vs-vendor max eigenvalue deviation: {dev:.2e}")
assert dev <= 5e-6 + 1e-4 * float(evals_xla.abs().max())

# the solver also takes any symmetric PSD matrix
G = torch.tensor((rng.normal(size=(384, 384)) / np.sqrt(384)).astype(np.float32),
                 device=DEVICE)
A = G @ G.T  # full-rank PSD, a continuous Marchenko-Pastur spectrum
ev, V = eigh_dc(A)
resid = torch.linalg.norm(A @ V[:, -5:] - V[:, -5:] * ev[None, -5:])
print(f"eigh_dc top-5 residual on a 384² PSD matrix: {float(resid):.2e}")

# 2) the streamed memory mode: the same spectrum
(evals_streamed,) = vtt.eigvalsh_streamed(model, loss, None, X, y, device=DEVICE)
dev_s = float((evals_streamed - evals_xla).abs().max())
print(f"streamed-vs-in-memory max deviation: {dev_s:.2e}")
assert dev_s <= 5e-6 + 1e-4 * float(evals_xla.abs().max())

print("fast-eigensolver example OK")
