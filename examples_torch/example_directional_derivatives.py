"""Directional derivatives along GGN eigenvectors with the PyTorch port
(the twin of ``examples/example_directional_derivatives.py``).

γ[n, k]: per-sample first-order derivative along direction k; λ[n, k]:
per-sample curvature.  Their means are the directional gradient and
curvature of the mini-batch loss.  Runs on the CUDA card when there is one,
else on the CPU.
"""

import numpy as np
import torch

import vivit_tpu_torch as vtt
from vivit_tpu_torch.models import MLP

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"
N, D_IN, C = 16, 6, 3
rng = np.random.default_rng(2)
X = rng.normal(size=(N, D_IN)).astype(np.float32)
y = rng.integers(0, C, size=(N,))

torch.manual_seed(2)
model = MLP(D_IN, (16, C)).to(DEVICE)
loss = vtt.CrossEntropyLoss("mean")

comp = vtt.DirectionalDerivativesComputation(
    model, loss,
    subsampling_grad=None,                # all samples for γ
    subsampling_ggn=[0, 2, 4, 6, 8, 10],  # curvature sub-sampling
    device=DEVICE,
)
group = {"params": [name for name, _ in model.named_parameters()],
         "criterion": vtt.keep_top_k(3, must_exceed=1e-5)}
((gammas, lambdas),) = comp.compute(X, y, [group])

print(f"gammas: {tuple(gammas.shape)}  (samples × directions)")
print(f"lambdas: {tuple(lambdas.shape)}")
print(f"mean directional gradients  γ̄ₖ = {gammas.mean(0).cpu().numpy()}")
print(f"mean directional curvatures λ̄ₖ = {lambdas.mean(0).cpu().numpy()}")
assert bool((lambdas.mean(0) > 0).all()), "GGN curvature is PSD"
print("Directional curvatures are positive. ✓")
