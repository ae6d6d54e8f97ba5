"""Computing GGN eigenvalues with the PyTorch port (the twin of
``examples/example_eigvalsh.py``).

Synthetic classification data and a small MLP; the Gram-space eigenvalues
are checked against an explicit GGN built from full Jacobians (rtol 1e-4,
atol 5e-6).  Runs on the CUDA card when there is one, else on the CPU.
"""

import copy

import numpy as np
import torch
from torch.func import functional_call, hessian, jacrev, vmap

import vivit_tpu_torch as vtt
from vivit_tpu_torch.models import MLP
from vivit_tpu_torch.utils.tree import ravel, unravel_like

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"
N, D_IN, C = 16, 10, 4

rng = np.random.default_rng(0)
X = rng.normal(size=(N, D_IN)).astype(np.float32)
y = rng.integers(0, C, size=(N,))

torch.manual_seed(0)
model = MLP(D_IN, (32, C)).to(DEVICE)
loss = vtt.CrossEntropyLoss("mean")

# one GGN block over all parameters (the default)
comp = vtt.EigvalshComputation(model, loss, device=DEVICE)
(evals,) = comp.compute(X, y)
print(f"Top-5 GGN eigenvalues: {evals[-5:].cpu().numpy()}")

# verify against an explicit GGN (brute force, float64)
model64 = copy.deepcopy(model).double()
params = {name: p.detach() for name, p in model64.named_parameters()}
Xd = torch.tensor(X, dtype=torch.float64, device=DEVICE)
yt = torch.tensor(y, device=DEVICE)
flat0 = ravel(params)


def outputs(flat):
    return functional_call(model64, unravel_like(flat, params), (Xd,))


J = jacrev(outputs)(flat0)  # [N, C, D]
f = outputs(flat0)
H = vmap(hessian(lambda f_n, y_n: loss.per_sample(f_n[None], y_n[None])[0]))(f, yt)
G = torch.einsum("nca,ncd,nde->ae", J, H, J) / N

explicit = np.linalg.eigvalsh(G.cpu().numpy())
top = min(evals.shape[0], flat0.shape[0])
assert np.allclose(evals.cpu().numpy()[-top:], explicit[-top:], rtol=1e-4, atol=5e-6)
print("Eigenvalues match the explicit GGN. ✓")

# per-layer block-diagonal approximation
groups = [{"params": [name]} for name, _ in model.named_parameters()]
blocks = comp.compute(X, y, groups)
for g, ev in zip(groups, blocks):
    print(f"block {g['params'][0]:>14s}: top eigenvalue {float(ev[-1]):.4f}")
