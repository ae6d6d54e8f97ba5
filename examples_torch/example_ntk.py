"""Empirical NTK through the Gram primitive, with the PyTorch port (the
twin of ``examples/example_ntk.py``).

``NTK(x₁, x₂) = J(x₁) J(x₂)ᵀ`` from the GGN Gram tensor of an MSE loss on
the stacked inputs: with ``MSELoss(reduction='sum')`` the loss-Hessian
square root is ``√2·I``, so the ``[C, N, C, N]`` Gram tensor is ``2·Jₙc·Jmd``
and the NTK is half its off-diagonal block.  Compared with an explicit
Jacobian contraction, and both timed.  Runs on the CUDA card when there is
one, else on the CPU.
"""

import time

import numpy as np
import torch
from torch.func import functional_call, jacrev

import vivit_tpu_torch as vtt
from vivit_tpu_torch.extensions import gram_sqrt_ggn
from vivit_tpu_torch.models import MLP
from vivit_tpu_torch.utils.tree import ravel, unravel_like

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"
N1, N2, D_IN, C = 8, 6, 10, 3
rng = np.random.default_rng(4)
X1 = torch.tensor(rng.normal(size=(N1, D_IN)).astype(np.float32), device=DEVICE)
X2 = torch.tensor(rng.normal(size=(N2, D_IN)).astype(np.float32), device=DEVICE)

torch.manual_seed(4)
model = MLP(D_IN, (32, C)).to(DEVICE)


def ntk_via_gram(X1, X2):
    """The NTK from the GGN Gram tensor of an MSE(sum) loss on the stacked
    inputs."""
    X = torch.cat([X1, X2])
    y_dummy = torch.zeros((X.shape[0], C), device=DEVICE)
    gram4 = gram_sqrt_ggn(model, vtt.MSELoss("sum"), X, y_dummy, device=DEVICE)
    # [C, N, C, N] → [n, m, c, d]; the MSE(sum) factor √2: divide by 2
    ntk = torch.einsum("cndm->nmcd", gram4) / 2.0
    return ntk[:N1, N1:]  # the off-diagonal block J(x₁) J(x₂)ᵀ


def ntk_via_jacobian(X1, X2):
    """Explicit Jacobian contraction (the functorch comparison)."""
    params = {name: p.detach() for name, p in model.named_parameters()}
    flat0 = ravel(params)

    def outs(flat, X):
        return functional_call(model, unravel_like(flat, params), (X,))

    J1 = jacrev(lambda f: outs(f, X1))(flat0)  # [N1, C, D]
    J2 = jacrev(lambda f: outs(f, X2))(flat0)  # [N2, C, D]
    return torch.einsum("ncd,mkd->nmck", J1, J2)


a = ntk_via_gram(X1, X2).cpu().numpy()
b = ntk_via_jacobian(X1, X2).cpu().numpy()
assert np.allclose(a, b, rtol=1e-4, atol=1e-6)
print(f"NTK block {a.shape} matches the explicit Jacobian contraction. ✓")

for name, f in [("gram", ntk_via_gram), ("jacobian", ntk_via_jacobian)]:
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        f(X1, X2).cpu()
        ts.append(time.perf_counter() - t0)
    print(f"{name:>9s}: {np.median(ts) * 1e3:.2f} ms on {DEVICE}")
