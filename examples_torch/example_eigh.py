"""Computing GGN eigenpairs with the PyTorch port (the twin of
``examples/example_eigh.py``): the leading GGN eigenvectors in parameter
space, checked for orthonormality, and the top-k function against the
class.  Runs on the CUDA card when there is one, else on the CPU.
"""

import numpy as np
import torch

import vivit_tpu_torch as vtt
from vivit_tpu_torch.models import MLP

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"
N, D_IN, C = 12, 8, 3

rng = np.random.default_rng(1)
X = rng.normal(size=(N, D_IN)).astype(np.float32)
y = rng.integers(0, C, size=(N,))

torch.manual_seed(1)
model = MLP(D_IN, (16, C)).to(DEVICE)
loss = vtt.CrossEntropyLoss("mean")
names = [name for name, _ in model.named_parameters()]

K = 4
comp = vtt.EighComputation(model, loss, device=DEVICE)
group = {"params": names, "criterion": vtt.keep_top_k(K, must_exceed=1e-5)}
((evals, evecs),) = comp.compute(X, y, [group])

print(f"kept {evals.shape[0]} directions, eigenvalues {evals.cpu().numpy()}")
for name, leaf in zip(names, evecs):
    print(f"  eigenvector block {name}: shape {tuple(leaf.shape)}")

# property check: orthonormality of the stacked eigenvectors
E = torch.cat([leaf.reshape(leaf.shape[0], -1) for leaf in evecs], dim=1).cpu().numpy()
assert np.allclose(E @ E.T, np.eye(E.shape[0]), atol=2e-4)
print("Eigenvectors are orthonormal. ✓")

# the top-k function
evals_k, _ = vtt.eigh_topk(model, loss, X, y, K, device=DEVICE)
assert np.allclose(evals_k.cpu().numpy(), evals.cpu().numpy(), rtol=1e-5, atol=1e-7)
print("eigh_topk agrees. ✓")
