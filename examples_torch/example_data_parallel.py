"""Data-parallel curvature with the PyTorch port (the twin of
``examples/example_data_parallel.py``).

The mini-batch is sharded over the ranks of a ``torch.distributed`` process
group: two CPU ranks over gloo, or, when there is a CUDA card, one rank on
it over NCCL.  Each rank computes the ``Vᵀ`` columns of its shard; the Gram
of the global batch is assembled with ``all_to_all`` and ``all_reduce``,
so the spectrum, the eigenpairs and the Newton steps are those of the whole
batch.  Every builder returns a function that every rank calls on its own
shard.
"""

import numpy as np
import torch

import vivit_tpu_torch as vtt
from vivit_tpu_torch.engines import forward_fn, module_params
from vivit_tpu_torch.models import MLP
from vivit_tpu_torch.parallel import eigvalsh_dp, newton_step_dp_structured, train_step_dp
from vivit_tpu_torch.parallel.launch import spawn

N_PER_RANK, D_IN, C = 4, 6, 3


def main(rank, k, device):
    def say(*args):
        if rank == 0:
            print(*args, flush=True)

    say(f"process group: {k} rank(s) on {device}")
    n_global = N_PER_RANK * k
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.normal(size=(n_global, D_IN)), dtype=torch.float32, device=device)
    y = torch.tensor(rng.integers(0, C, size=(n_global,)), device=device)
    local = slice(rank * N_PER_RANK, (rank + 1) * N_PER_RANK)
    X_l, y_l = X[local], y[local]
    torch.manual_seed(0)  # the same weights on every rank
    model = MLP(D_IN, (16, C)).to(device)
    model_fn, params = forward_fn(model), module_params(model)
    loss = vtt.CrossEntropyLoss("mean")

    # the global-batch GGN spectrum, the Gram assembled over the ranks
    evals = eigvalsh_dp(model_fn, loss, None, device=device)(params, X_l, y_l)
    say(f"global GGN top-3 eigenvalues: {evals[-3:].cpu().numpy()}")
    (evals_sd,) = vtt.eigvalsh(model_fn, loss, X, y, params=params, device=device)
    assert np.allclose(np.sort(evals.cpu().numpy()), evals_sd.cpu().numpy(),
                       rtol=1e-4, atol=5e-6)
    say("matches the single-device spectrum. ✓")

    # block-diagonal groups and global-index sub-sampling compose with DP
    names = list(params)
    groups = [[n for n in names if n.endswith("weight")],
              [n for n in names if not n.endswith("weight")]]
    per_group = eigvalsh_dp(model_fn, loss, None, group_paths=groups,
                            subsampling=list(range(0, n_global, 2)), device=device)(
        params, X_l, y_l)
    say("block-diagonal sub-sampled top eigenvalues:",
        [np.round(g[-2:].cpu().numpy(), 4) for g in per_group])

    # a few data-parallel second-order training steps
    step = train_step_dp(model_fn, loss, None, k_top=4, damping=1.0, lr=1.0, device=device)
    losses = [float(loss(model_fn(params, X), y))]
    for _ in range(3):
        params, evals = step(params, X_l, y_l)
        losses.append(float(loss(model_fn(params, X), y)))
    say("DP Newton loss trajectory:", [f"{v:.4f}" for v in losses])
    assert losses[-1] < losses[0]
    say("Distributed damped Newton reduces the loss. ✓")

    # the structured fast path (Kronecker-factored Linear blocks) of a module
    evals_s, step_s = newton_step_dp_structured(model, loss, None, k_top=4, damping=1.0,
                                                device=device)(X_l, y_l)
    assert all(bool(torch.isfinite(s).all()) for s in step_s)
    say("Structured (Kronecker-factored) DP Newton step. ✓")


if __name__ == "__main__":
    if torch.cuda.is_available():
        spawn(main, 1, ("cuda",), backend="nccl")
    else:
        spawn(main, 2, ("cpu",))
