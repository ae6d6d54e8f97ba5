"""Streamed memory mode with the PyTorch port: curvature pipelines without
the full ``Vᵀ`` (the twin of ``examples/example_memory_streamed.py``).

The exact-GGN ``Vᵀ`` is ``[C, N, D]``: for CIFAR-10 3c3d at ``N = 512``
that is 18 GB.  ``vivit_tpu_torch.chunked`` streams the factor (class) axis
so that at most two ``[N, D]`` slices are alive; the three streamed
pipelines match their in-memory counterparts here on a small problem.
Runs on the CUDA card when there is one, else on the CPU.
"""

import numpy as np
import torch

import vivit_tpu_torch as vtt
from vivit_tpu_torch.chunked import (
    eigh_topk_streamed,
    eigvalsh_streamed,
    newton_step_streamed,
)
from vivit_tpu_torch.models import MLP

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"
N, D_IN, C, K = 16, 10, 4, 3

rng = np.random.default_rng(0)
X = rng.normal(size=(N, D_IN)).astype(np.float32)
y = rng.integers(0, C, size=(N,))

torch.manual_seed(0)
model = MLP(D_IN, (32, C)).to(DEVICE)
loss = vtt.CrossEntropyLoss("mean")

# --- eigenvalues: streamed == in memory (a module needs no params dict) ----
(ev_std,) = vtt.eigvalsh(model, loss, X, y, device=DEVICE)
(ev_str,) = eigvalsh_streamed(model, loss, None, X, y, device=DEVICE)
assert np.allclose(ev_str.cpu().numpy(), ev_std.cpu().numpy(), rtol=1e-4, atol=5e-6)
print(f"streamed eigenvalues match (top-3: {ev_str[-3:].cpu().numpy()})")

# --- eigenpairs: the back-projection streams factor by factor ------------
ev_a, vecs_a = vtt.eigh_topk(model, loss, X, y, K, device=DEVICE)
ev_b, vecs_b = eigh_topk_streamed(model, loss, None, X, y, K, device=DEVICE)
assert np.allclose(ev_b.cpu().numpy(), ev_a.cpu().numpy(), rtol=1e-4, atol=5e-6)
flat_a = torch.cat([v.reshape(K, -1) for v in vecs_a], dim=1)
flat_b = torch.cat([v.reshape(K, -1) for v in vecs_b], dim=1)
assert np.allclose((flat_a * flat_b).sum(1).abs().cpu().numpy(), 1.0, atol=1e-3)
print("streamed eigenpairs match (sign-invariant)")


# --- damped Newton step, with the damping-callable protocol ---------------
def damping(evals, evecs, gammas, lambdas):
    return 1.0 + 0.1 * lambdas.mean(dim=0)


step_std = vtt.newton_step_topk(model, loss, X, y, K, damping=damping, device=DEVICE)
step_str = newton_step_streamed(model, loss, None, X, y, K, damping=damping, device=DEVICE)
for a, b in zip(step_std, step_str):
    assert np.allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-4, atol=1e-6)
print("streamed Newton step matches")
