"""Multi-rank dry run of the data-parallel pipelines (the twin of
``__graft_entry__.dryrun_multichip``), over a gloo group of CPU ranks.

    python -m vivit_tpu_torch.parallel.dryrun 8

Three legs, each on every rank with 2 samples per rank and 3 classes:

1. ``train_step_dp`` on a dense MLP: the full second-order step (per-rank
   ``Vᵀ``, resharded Gram, replicated eigensolve, per-rank γ/λ, the step
   assembled with ``all_reduce``); the eigenvalues finite and the
   parameters moved;
2. ``eigvalsh_dp_structured(engine="tapped")`` on a tiny conv net: Dense
   factors through ``all_gather``, conv blocks through ``all_to_all`` and
   ``all_reduce``;
3. ``eigvalsh_streamed_dp`` on the same net, which must agree with leg 2's
   spectrum (rtol 1e-4, atol 5e-6).
"""

import sys

import numpy as np
import torch
from torch import nn

RTOL, ATOL = 1e-4, 5e-6


class TinyConv(nn.Module):
    """Conv 3@3x3 (zero padding 1) → ReLU → flatten → Dense 3, NHWC input."""

    def __init__(self, in_channels: int = 2, side: int = 5, num_classes: int = 3):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, 3, 3, padding=1)
        self.dense0 = nn.Linear(3 * side * side, num_classes)

    def forward(self, x):
        return self.dense0(torch.relu(self.conv0(x.permute(0, 3, 1, 2))).flatten(1))


def _legs(rank: int, k: int) -> dict:
    """The three legs on this rank; returns the numbers rank 0 prints."""
    import vivit_tpu_torch as vtt
    from vivit_tpu_torch.engines import forward_fn, module_params
    from vivit_tpu_torch.models import MLP
    from vivit_tpu_torch.parallel import (
        eigvalsh_dp_structured,
        eigvalsh_streamed_dp,
        train_step_dp,
    )

    cpu = dict(device="cpu")
    loss = vtt.CrossEntropyLoss("mean")
    rng = np.random.default_rng(0)
    n_global = 2 * k
    local = slice(2 * rank, 2 * rank + 2)

    # leg 1: the data-parallel training step (weights from the same seed on
    # every rank)
    torch.manual_seed(0)
    mlp = MLP(6, (8, 3))
    X = torch.tensor(rng.normal(size=(n_global, 6)), dtype=torch.float32)
    y = torch.tensor(rng.integers(0, 3, size=(n_global,)))
    params = module_params(mlp)
    step = train_step_dp(forward_fn(mlp), loss, None, k_top=2, damping=1.0, lr=0.1, **cpu)
    new_params, evals = step(params, X[local], y[local])
    assert bool(torch.isfinite(evals).all()), "non-finite eigenvalues"
    delta = sum(float((a - b).abs().sum()) for a, b in
                zip(new_params.values(), params.values()))
    assert delta > 0, "the training step did not update the parameters"

    # leg 2: the structured (tapped) builder on a conv net
    torch.manual_seed(1)
    conv = TinyConv().eval()
    Xc = torch.tensor(rng.normal(size=(n_global, 5, 5, 2)), dtype=torch.float32)
    yc = torch.tensor(rng.integers(0, 3, size=(n_global,)))
    ev_struct = eigvalsh_dp_structured(conv, loss, None, engine="tapped", **cpu)(
        Xc[local], yc[local])
    assert bool(torch.isfinite(ev_struct).all()), "non-finite structured-DP eigenvalues"

    # leg 3: factor streaming on every rank, the same spectrum
    ev_streamed = eigvalsh_streamed_dp(forward_fn(conv), loss, None, **cpu)(
        module_params(conv), Xc[local], yc[local])
    a, b = torch.sort(ev_struct).values, torch.sort(ev_streamed).values
    assert torch.allclose(a, b, rtol=RTOL, atol=ATOL), (
        f"structured-DP vs streamed-DP spectrum mismatch: {(a - b).abs().max().item()}")
    return {"evals": evals.tolist(), "delta": delta, "lmax": a[-1].item()}


def dryrun_multichip(n_devices: int) -> None:
    """Run the three legs in a gloo group of ``n_devices`` CPU ranks
    (spawned here); raises if a leg fails on any rank."""
    from vivit_tpu_torch.parallel.launch import spawn

    out = spawn(_legs, n_devices)[0]
    print(f"dryrun_multichip({n_devices}): OK — top evals {np.asarray(out['evals'])}, "
          f"|Δparams|₁ = {out['delta']:.3e}")
    print(f"dryrun_multichip({n_devices}): structured-DP(tapped, conv) and streamed-DP legs "
          f"OK — λmax {out['lmax']:.4f} (both engines agree)")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
