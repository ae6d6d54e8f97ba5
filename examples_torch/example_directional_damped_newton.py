"""Damped Newton steps in the GGN eigenbasis with the PyTorch port (the
twin of ``examples/example_directional_damped_newton.py``): a few
second-order training steps on synthetic data, the loss decreasing.  Runs
on the CUDA card when there is one, else on the CPU.
"""

import numpy as np
import torch

import vivit_tpu_torch as vtt
from vivit_tpu_torch.models import MLP

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"
N, D_IN, C = 32, 8, 3
rng = np.random.default_rng(3)
X = torch.tensor(rng.normal(size=(N, D_IN)).astype(np.float32), device=DEVICE)
y = torch.tensor(rng.integers(0, C, size=(N,)), device=DEVICE)

torch.manual_seed(3)
model = MLP(D_IN, (16, C)).to(DEVICE)
loss = vtt.CrossEntropyLoss("mean")

# the class with criterion and damping callables (the reference protocol)
comp = vtt.DirectionalDampedNewtonComputation(model, loss, device=DEVICE)
group = {
    "params": [name for name, _ in model.named_parameters()],
    "criterion": vtt.keep_top_k(8, must_exceed=1e-4),
    "damping": vtt.constant_damping(1.0),
}


def batch_loss():
    with torch.no_grad():
        return float(loss(model(X), y))


losses = [batch_loss()]
for _ in range(5):
    (step,) = comp.compute(X, y, [group])
    with torch.no_grad():
        for p, delta in zip(model.parameters(), step):
            p.add_(delta)
    losses.append(batch_loss())

print("loss trajectory:", [f"{value:.4f}" for value in losses])
assert losses[-1] < losses[0], "Newton steps should reduce the loss"
print("Loss decreased under damped Newton. ✓")

# the one-call step for a training loop
step = vtt.newton_step_topk(model, loss, X, y, k=8, damping=1.0, device=DEVICE)
print("newton_step_topk leaf norms:", [f"{float(s.norm()):.2e}" for s in step])
