"""Matrix-free GGN spectral analysis over a dataset with the PyTorch port
(the twin of ``examples/example_spectral_density.py``).

The dataset GGN as a linear operator (no D×D matrix is ever formed), its
spectral density by stochastic Lanczos quadrature, and its extreme
eigenvalues by ARPACK, with the Lanczos sweep on the device alongside the
SciPy-compatible path.  Runs on the CUDA card when there is one, else on
the CPU.
"""

import numpy as np
import torch

import vivit_tpu_torch as vtt
from vivit_tpu_torch.hessianfree import (
    GGNLinearOperator,
    approximate_boundaries,
    fast_lanczos_jax,
    ggn_operator,
    lanczos_approximate_spectrum,
)
from vivit_tpu_torch.models import MLP

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"

# a small dataset of 4 equal batches
rng = np.random.default_rng(7)
torch.manual_seed(7)
model = MLP(6, (16, 3)).to(DEVICE)
loss = vtt.CrossEntropyLoss("mean")
data = [(rng.normal(size=(8, 6)).astype(np.float32), rng.integers(0, 3, size=(8,)))
        for _ in range(4)]
dim = sum(p.numel() for p in model.parameters())

# SciPy-compatible operator (for eigsh/ARPACK workflows)
op = GGNLinearOperator(model, loss, None, data, check_deterministic=True, device=DEVICE)
lo, hi = approximate_boundaries(op)
print(f"GGN spectral boundaries (ARPACK): [{lo:.4f}, {hi:.4f}]")

grid, density = lanczos_approximate_spectrum(op, ncv=32, num_points=256, num_repeats=2,
                                             boundaries=(lo, hi), seed=0)
mass = np.trapezoid(density, grid)
print(f"Lanczos spectral density: {len(grid)} grid points, mass ≈ {mass:.3f}")
assert 0.5 < mass < 1.5

# on the device: the dataset matvec and a Lanczos sweep with no host read
matvec = ggn_operator(model, loss, None, data, device=DEVICE)
evals_T, _ = fast_lanczos_jax(matvec, dim, ncv=32, key=0, device=DEVICE)
print(f"on-device Lanczos extreme Ritz values: [{float(evals_T[0]):.4f}, "
      f"{float(evals_T[-1]):.4f}]")
assert np.isclose(float(evals_T[-1]), hi, rtol=5e-2)
print("Extreme Ritz value matches ARPACK λmax. ✓")
