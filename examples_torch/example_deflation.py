"""Analytic CE null-space deflation with the PyTorch port (the twin of
``examples/example_deflation.py``).

For the exact cross-entropy loss every sample's factor rows obey one
linear dependence (``Σ_c √p_c · s_{n,c} = 0``), so the ``[CN × CN]`` Gram
carries ``N`` structural zeros with known eigenvectors; ``deflate_ce_null``
turns that into an exact reduction of every eigenproblem from ``C·N`` to
``(C−1)·N``, the zeros returned exactly.  Runs on the CUDA card when there
is one, else on the CPU.
"""

import numpy as np
import torch

import vivit_tpu_torch as vtt
from vivit_tpu_torch.models import MLP

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"
N, D_IN, C = 32, 10, 6

rng = np.random.default_rng(0)
X = rng.normal(size=(N, D_IN)).astype(np.float32)
y = rng.integers(0, C, size=(N,))

torch.manual_seed(0)
model = MLP(D_IN, (40, C)).to(DEVICE)
loss = vtt.CrossEntropyLoss("mean")
names = [name for name, _ in model.named_parameters()]

# 1) the deflated spectrum equals the full one, with exact zeros
(evals_full,) = vtt.eigvalsh(model, loss, X, y, device=DEVICE)
(evals_defl,) = vtt.eigvalsh(model, loss, X, y, deflate_ce_null=True, device=DEVICE)
lmax = float(evals_full[-1])
assert np.allclose(evals_defl.cpu().numpy(), evals_full.cpu().numpy(),
                   rtol=1e-4, atol=5e-6 * max(1.0, lmax))
assert float(evals_defl[:N].abs().max()) == 0.0  # exact zeros
print(f"deflated spectrum matches (λmax {lmax:.4f}); {N} exact zeros")


# 2) eigenpairs: the analytic null vectors and the lifted nonzero pairs
def top4(ev):
    return list(range(len(ev) - 4, len(ev)))


group = [{"params": names, "criterion": top4}]
((_, evecs_top),) = vtt.EighComputation(model, loss, deflate_ce_null=True,
                                        device=DEVICE).compute(X, y, group)
((_, evecs_ref),) = vtt.EighComputation(model, loss, device=DEVICE).compute(X, y, group)
for got, want in zip(evecs_top, evecs_ref):
    g, w = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    dots = (g * w).sum(1).abs() / (g.norm(dim=1) * w.norm(dim=1))
    assert float(dots.min()) > 0.999  # the same directions up to sign
print("deflated eigenpairs match the undeflated computation")

# 3) the damped Newton step is unchanged to f32 noise, its top-k cheaper
step = vtt.newton_step_topk(model, loss, X, y, k=3, damping=1.0, device=DEVICE)
step_d = vtt.newton_step_topk(model, loss, X, y, k=3, damping=1.0, deflate_ce_null=True,
                              device=DEVICE)
for a, b in zip(step, step_d):
    assert np.allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-4, atol=1e-5)
print("deflated Newton step matches")

# 4) guardrails: deflation is for the exact cross-entropy only
try:
    vtt.eigvalsh(model, vtt.MSELoss("mean"), X, np.zeros((N, C), np.float32),
                 deflate_ce_null=True, device=DEVICE)
    raise AssertionError("should have raised")
except ValueError as e:
    print(f"MSE correctly rejected: {str(e)[:60]}...")
