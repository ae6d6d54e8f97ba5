#!/usr/bin/env python3
"""The port's data-parallel builders across every CUDA card of this host,
one NCCL rank per card.

    PYTHONPATH=. python3 tools/torch_dp_cards.py

CIFAR-10 3c3d at N=128 with the headline settings (bf16 Gram, CE
deflation, the dc eigensolver), weights ``cnn3c3d_flax_params(seed=0)``,
data numpy ``default_rng(0)``; rank ``r`` holds samples ``r·N/k`` to
``(r+1)·N/k − 1``.  For ``eigvalsh_dp_structured``,
``newton_step_dp_structured`` (k=10, dc) and ``eigvalsh_streamed_dp``: the
call time over the ``k`` ranks (host clock around a synchronised call on
every rank, median of 3 after a warm-up) and the result against the same
builder at world size 1 on card 0 (a one-rank group) on the whole batch,
eigenvalues within BASELINE's bar (rtol 1e-4, atol 5e-6·λmax), the step
within 1e-3 of max|step|.  Then the bare collectives of the structured
call: ``all_to_all_single`` of its conv/bias ``V`` rows and ``all_reduce``
of its Gram (CUDA events, median).  Exits non-zero if a check fails.
"""

import subprocess
import sys
import time

import numpy as np

N, TOP_K = 128, 10
RTOL, ATOL = 1e-4, 5e-6
STEP_BAR = 1e-3
HEADLINE = dict(precision="highest", gram_precision="bf16", deflate_ce_null=True)


def _rank(rank, k):
    import torch
    import torch.distributed as dist
    from torch.func import functional_call

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import parallel as par
    from vivit_tpu_torch.convert import params_from_flax
    from vivit_tpu_torch.models import cnn3c3d_flax_params

    device = torch.device("cuda", torch.cuda.current_device())
    state = params_from_flax(cnn3c3d_flax_params(seed=0))
    model = vtt.CNN3c3d(10)
    model.load_state_dict(state)
    model = model.to(device).eval()
    net = vtt.CNN3c3d(10)
    params = {name: p.to(device) for name, p in state.items()}

    def model_fn(p, x):
        return functional_call(net, p, (x,))

    rng = np.random.default_rng(0)
    X = torch.tensor(rng.normal(size=(N, 32, 32, 3)).astype(np.float32), device=device)
    y = torch.tensor(rng.integers(0, 10, size=(N,)), device=device)
    n = N // k
    X_l, y_l = X[rank * n:(rank + 1) * n], y[rank * n:(rank + 1) * n]
    solo = dist.new_group([0])  # every rank creates it, rank 0 uses it
    loss = vtt.CrossEntropyLoss("mean")
    builders = {
        "eigvalsh_dp_structured": lambda g: par.eigvalsh_dp_structured(
            model, loss, g, eig_backend="dc", device=device, **HEADLINE),
        "newton_step_dp_structured (dc)": lambda g: par.newton_step_dp_structured(
            model, loss, g, TOP_K, 1.0, solver="dc", device=device, **HEADLINE),
        "eigvalsh_streamed_dp": lambda g: par.eigvalsh_streamed_dp(
            model_fn, loss, g, eig_backend="dc", device=device, **HEADLINE),
    }
    calls = {"eigvalsh_dp_structured": lambda fn, X_, y_: fn(X_, y_),
             "newton_step_dp_structured (dc)": lambda fn, X_, y_: fn(X_, y_)[1],
             "eigvalsh_streamed_dp": lambda fn, X_, y_: fn(params, X_, y_)}

    out = {"times": {}, "ref": {}, "got": {}}
    for name, build in builders.items():
        fn = build(None)
        call = calls[name]
        got = call(fn, X_l, y_l)  # the warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            got = call(fn, X_l, y_l)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["times"][name] = float(np.median(times))
        out["got"][name] = [t.cpu().numpy() for t in got] if isinstance(got, list) \
            else got.cpu().numpy()

    # the bare collectives of the structured call
    with_v = []
    original = par.sharded_gram

    def recording(v, group=None, precision=None):
        with_v.append(v)
        return original(v, group, precision)

    par.sharded_gram = recording
    try:
        builders["eigvalsh_dp_structured"](None)(X_l, y_l)
    finally:
        par.sharded_gram = original
    v = torch.nn.functional.pad(with_v[0], (0, (-with_v[0].shape[1]) % k))
    send = v.reshape(v.shape[0], k, -1).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    gram = torch.zeros((v.shape[0] * k,) * 2, device=device)
    out["a2a"] = (_cuda_ms(lambda: dist.all_to_all_single(recv, send)), send.numel() * 4,
                  tuple(v.shape))
    out["ar"] = (_cuda_ms(lambda: dist.all_reduce(gram)), gram.numel() * 4)

    if rank == 0:  # the same builders at world size 1 on the whole batch
        for name, build in builders.items():
            got = calls[name](build(solo), X, y)
            out["ref"][name] = [t.cpu().numpy() for t in got] if isinstance(got, list) \
                else got.cpu().numpy()
    dist.barrier()
    return out


def _cuda_ms(fn, reps=10):
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main():
    import torch

    from vivit_tpu_torch.parallel.launch import spawn

    if not torch.cuda.is_available():
        print("torch_dp_cards: no CUDA device", file=sys.stderr)
        return 2
    k = torch.cuda.device_count()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"{k} ranks (NCCL), {N // k} samples each, torch {torch.__version__}", flush=True)
    out = spawn(_rank, k, backend="nccl", timeout=900)[0]
    failed = []
    for name, ms in out["times"].items():
        got, ref = out["got"][name], out["ref"][name]
        if isinstance(ref, list):
            dev = (max(np.abs(a - b).max() for a, b in zip(got, ref))
                   / max(np.abs(b).max() for b in ref))
            ok, what = dev <= STEP_BAR, f"max|Δ|/max|step| {dev:.3e} (bar {STEP_BAR:.0e})"
        else:
            ref64 = ref.astype(np.float64)
            ratio = (np.abs(got - ref64) / (ATOL * np.abs(ref64).max() + RTOL * np.abs(ref64))).max()
            ok, what = ratio <= 1.0, f"eigenvalues max err/tol {ratio:.3f}"
        print(f"{name}: {k} ranks {ms:.3f} ms median of 3 (host clock); against world size "
              f"1 on the whole batch: {what}", flush=True)
        if not ok:
            failed.append(name)
    (t_a2a, a2a_bytes, shape), (t_ar, ar_bytes) = out["a2a"], out["ar"]
    print(f"collectives over {k} ranks: all_to_all_single of the V rows {shape} f32 per rank "
          f"({a2a_bytes / 1e9:.3f} GB) {t_a2a:.3f} ms; all_reduce of the Gram "
          f"({ar_bytes / 1e6:.3f} MB) {t_ar:.4f} ms (CUDA events on rank 0, median of 10)",
          flush=True)
    if failed:
        print(f"torch_dp_cards: FAIL: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
