#!/usr/bin/env python3
"""The measurements behind the port's ``batched_eigh`` dispatch, on one
CUDA card.

    PYTHONPATH=. python3 tools/torch_eigh_routes.py

``vivit_tpu_torch/kernels/jacobi.py`` has two routes: the Jacobi kernel for
f32 ``[b, m, m]`` with m in its compiled sizes, one batched
``torch.linalg.eigh`` else.  The JAX package has a third, a ``lax.map`` of
single solves for multi-batch blocks of m >= 256, measured on a TPU.  This
script measures the three questions that set the port's policy:

1. **The kernel past the smoke's shape sweep**: the kernel against
   ``torch.linalg.eigh`` at b in {1024, 4096} (m=32) and b=1024 (m=48,
   64), each result held to float64 (``chip_smoke.check_eigh``).
2. **The leaf sweep**: one batched ``torch.linalg.eigh`` against a Python
   loop of single calls, stacked (the counterpart of ``lax.map``), on the
   paths' leaf shapes and a bracket of m from 96 to 2048.
3. **In situ**: every batch that the N=128 and N=512 spectrum and
   eigenpair solves of CIFAR-10 3c3d (headline settings, the smoke's
   weights and data) hand ``batched_eigh``, each timed through one batched
   call and through the kernel (m in its sizes) or the loop (other
   multi-batch blocks), with the route that the TPU's envelope (kernel for
   b·m <= 2048, m in {32, 48, 64}; batched else) and that the port gives
   it; then each whole solve under either dispatch, in turns, run through
   the eager body (a chain-path solve replayed from its CUDA graphs keeps
   the dispatch it was captured with).

CUDA events, median and [min-max] of 5 (of 3 in situ).  Exits non-zero if
a check fails.
"""

import subprocess
import sys

import numpy as np

import chip_smoke as smoke

KERNEL_SHAPES = [(1024, 32), (4096, 32), (1024, 48), (1024, 64)]
# N=128's ladder leaves, N=512's bulk-tree leaves and a bracket around the
# JAX package's threshold of 256
LEAF_SHAPES = [(16, 150), (8, 421), (4, 421), (2, 421), (2, 384)] + [
    (b, m) for m in (96, 128, 192, 256, 320) for b in (2, 8, 16)] + [
    (2, 512), (8, 512), (2, 768), (2, 1024), (2, 1536), (2, 2048)]


def loop_eigh(A):
    """One ``torch.linalg.eigh`` per matrix, stacked."""
    import torch

    evals, evecs = zip(*(torch.linalg.eigh(a) for a in A))
    return torch.stack(evals), torch.stack(evecs)


def tpu_route(A, jc):
    """The dispatch by the TPU's envelope: the kernel for f32 with m in its
    sizes and b·m <= 2048, one batched call else."""
    import torch

    b, m = A.shape[0], A.shape[-1]
    fits = A.dtype == torch.float32 and m in jc.KERNEL_SIZES and b * m <= 2048
    return "jacobi" if fits else "batched"


def kernel_sweep(jc):
    import torch

    for b, m in KERNEL_SHAPES:
        A = torch.tensor(smoke.random_sym(b, m, seed=b * 1000 + m), device="cuda")
        label = f"kernel [{b},{m},{m}]"
        ev, V = jc.batched_eigh_jacobi_cuda(A)
        torch.cuda.synchronize()
        _, err64 = smoke.check_eigh(A, ev, V, label)
        t_k = smoke.cuda_times(lambda: jc.batched_eigh_jacobi_cuda(A), reps=5, warmup=1)
        t_l = smoke.cuda_times(lambda: torch.linalg.eigh(A), reps=5, warmup=1)
        print(f"{label}: kernel {smoke.spread(t_k)}, torch.linalg.eigh "
              f"{smoke.spread(t_l)}, kernel/eigh {np.median(t_k) / np.median(t_l):.3f}; "
              f"max|kernel-f64| {err64:.3e}", flush=True)


def leaf_sweep():
    import torch

    for b, m in LEAF_SHAPES:
        A = torch.tensor(smoke.random_sym(b, m, seed=b * 1000 + m), device="cuda")
        label = f"leaf [{b},{m},{m}]"
        ev, _ = torch.linalg.eigh(A)
        gap = (ev - loop_eigh(A)[0]).abs().max().item()
        smoke.check(gap <= 1e-5 * ev.abs().max().item(),
                    f"{label}: the loop's eigenvalues {gap:.2e} off the batched call's")
        t_b = smoke.cuda_times(lambda: torch.linalg.eigh(A), reps=5, warmup=1)
        t_m = smoke.cuda_times(lambda: loop_eigh(A), reps=5, warmup=1)
        print(f"{label}: batched {smoke.spread(t_b)}, loop of {b} singles "
              f"{smoke.spread(t_m)}, loop/batched {np.median(t_m) / np.median(t_b):.3f}",
              flush=True)


def in_situ(jc):
    import torch

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch.kernels.jacobi import jacobi_supported
    from vivit_tpu_torch.precision import _PRECISIONS, full_f32
    from vivit_tpu_torch.structured import gram_matrix_mixed
    from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt

    routes = {"batched": torch.linalg.eigh, "loop": loop_eigh,
              "jacobi": lambda A: jc.batched_eigh_jacobi(A.contiguous())}
    model = smoke.port_model()
    loss = vtt.CrossEntropyLoss("mean")
    solves = []
    for n in (smoke.N, smoke.N_LARGE):
        X, y = smoke.port_batch(n)
        with full_f32():
            gram = gram_matrix_mixed(tapped_ggn_sqrt_vt(model, loss, X, y, deflate_ce_null=True),
                                     generic_precision=_PRECISIONS["bf16"])
        gram_d = smoke.deflated_gram(model, loss, X, y)[2]
        solves += [(f"eigvalsh_structured N={n}", lambda g=gram: eigdc.eigvalsh_dc(g)),
                   (f"eigh_topk N={n}", lambda g=gram_d: eigdc.eigh_dc(g))]
    for label, solve in solves:
        with full_f32():
            _, batches = smoke.recording_eigh(solve)
        totals = {"TPU": 0.0, "port": 0.0}
        for A in batches:
            b, m = A.shape[0], A.shape[-1]
            other = "jacobi" if m in jc.KERNEL_SIZES else "loop" if b > 1 else None
            times = {name: smoke.cuda_times(lambda: routes[name](A), reps=3, warmup=1)
                     for name in ("batched", other) if name}
            was = tpu_route(A, jc)
            now = "jacobi" if jacobi_supported(A.shape, A.dtype) else "batched"
            totals["TPU"] += np.median(times[was])
            totals["port"] += np.median(times[now])
            print(f"{label} in situ [{b},{m},{m}]: " + ", ".join(
                f"{name} {smoke.spread(t)}" for name, t in times.items())
                + f"; route: TPU envelope {was}, port {now}", flush=True)
        print(f"{label} in situ, {len(batches)} batches: the TPU envelope's routes "
              f"{totals['TPU']:.3f} ms, the port's {totals['port']:.3f} ms", flush=True)
        solve_ms = {"TPU": [], "port": []}
        this = eigdc.batched_eigh
        for name in ("TPU", "port", "port", "TPU"):
            if name == "TPU":
                eigdc.batched_eigh = lambda A: routes[tpu_route(A, jc)](A)
            try:
                with full_f32():
                    solve_ms[name] += smoke.cuda_times(solve, reps=1, warmup=0)
            finally:
                eigdc.batched_eigh = this
        print(f"{label} eigensolve under the TPU envelope "
              f"{[round(t, 3) for t in solve_ms['TPU']]} ms, under the port's "
              f"{[round(t, 3) for t in solve_ms['port']]} ms (one call each, in turns)",
              flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_eigh_routes: no CUDA device", file=sys.stderr)
        return 2
    from vivit_tpu_torch.kernels import jacobi_cuda as jc

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    jc.build()
    try:
        kernel_sweep(jc)
        leaf_sweep()
        with smoke.eager_body():
            in_situ(jc)
    except smoke.SmokeFailure as exc:
        print(f"torch_eigh_routes: FAIL: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
