#!/usr/bin/env python3
"""The measurements behind the port's ``batched_eigh`` dispatch, on one
CUDA card.

    PYTHONPATH=. python3 tools/torch_eigh_routes.py

``vivit_tpu_torch/kernels/jacobi.py`` routes a batch three ways: the window
kernel for f32 ``[b, m, m]`` with m in its compiled sizes, the leaf kernel
for any other f32 m <= 160 on the card, one batched ``torch.linalg.eigh``
else.  The JAX package has another, a ``lax.map`` of single solves for
multi-batch blocks of m >= 256, measured on a TPU.  This script measures
the questions that set the port's policy:

1. **The window kernel past the smoke's shape sweep**: against
   ``torch.linalg.eigh`` at b in {1024, 4096} (m=32) and b=1024 (m=48,
   64), each result held to float64 (``chip_smoke.check_eigh``).
2. **The vendor's blocks**: one batched ``torch.linalg.eigh`` against a
   Python loop of single calls, stacked (the counterpart of ``lax.map``),
   on the paths' leaf shapes and a bracket of m from 96 to 2048.
3. **In situ, the leaf route against the parent's**: every batch that the
   N=128 and N=512 spectrum and eigenpair solves of CIFAR-10 3c3d
   (headline settings, the smoke's weights and data) hand
   ``batched_eigh``, timed through each route that can take it (the
   batched eigh, the loop for multi-batch vendor blocks, the window or the
   leaf kernel), with the port's route beside the parent's (the leaf range
   on the vendor); then each whole solve under the four rules of
   :func:`rules`, in turns, run through the eager body (a strip-path
   solve routes its batches as solved outside any graph); then the N=128
   headline and ``eigh_topk`` calls captured whole and replayed under the
   four rules, in turns (each turn drops the graphs and captures anew: a
   replay keeps the rule it was captured with).  The rules are patched
   here, never in the package.  Each batch of the leaf kernel's range
   also runs at a cap of 30 sweeps: the sweeps its exact exit takes, and
   its accuracy against float64 at both caps beside the vendor's.
4. **One matrix** (b = 1, m from 33 to 95): the leaf kernel against
   ``torch.linalg.eigh``, where one SM stops beating the vendor.
5. **The training steps' guard**: ``train_step_dp``'s three steps from
   ``chip_smoke.py``'s phase 13 (an NCCL group of world size 1, fresh
   cuDNN draws each time), repeated under the port's rule and the
   parent's in turns, each solve's guard bound, orthonormality and trip;
   a tripped Gram is saved and solved again under each leaf route
   (``chip_smoke.replay_trips``); the third step's Gram of each rule's
   last run, and the first tripped one, solved alone under both rules
   with 16 seeds (:func:`cross_solves`).

CUDA events, median and [min-max] of 5 (of 3 in situ).  Exits non-zero if
a check fails.
"""

import subprocess
import sys

import numpy as np

import chip_smoke as smoke

KERNEL_SHAPES = [(1024, 32), (4096, 32), (1024, 48), (1024, 64)]
SINGLES = (33, 40, 56, 66, 72, 80, 88, 95)
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


def rules():
    """The route rules compared, by name: the port's (``jacobi.route``: a
    single matrix of m >= 72 on the vendor outside any graph, that is on
    the strip path); the parent's (the leaf range on the vendor); the
    single matrices on the vendor everywhere, in captured solves too; and
    the leaf kernel everywhere, on the strip path too."""
    from vivit_tpu_torch.kernels import jacobi

    port = jacobi.route

    def parent(shape, dtype, device, eager=False):
        way = port(shape, dtype, device, eager)
        return "vendor" if way == "leaf" else way

    return {"parent": parent, "port": port,
            "singles on the vendor": lambda shape, dtype, device, eager=False: port(
                shape, dtype, device, True),
            "kernel everywhere": lambda shape, dtype, device, eager=False: port(
                shape, dtype, device, False)}


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


def accuracy(A, ev, V):
    """``(eigenvalues' max err/tol against float64 at BASELINE's bar,
    max|VᵀV − I|)``."""
    import torch

    ref = torch.linalg.eigvalsh(A.double())
    tol = smoke.ATOL * ref.abs().amax(dim=-1, keepdim=True) + smoke.RTOL * ref.abs()
    eye = torch.eye(A.shape[-1], dtype=torch.float64, device=A.device)
    V64 = V.double()
    return (((ev.double() - ref).abs() / tol).max().item(),
            (V64.transpose(-1, -2) @ V64 - eye).abs().max().item())


def sweep_caps(jl, A, label):
    """A leaf batch at the route's cap of 12 sweeps and at 30: the sweeps
    each matrix runs and the accuracy of both, beside the vendor's."""
    import torch

    rows = []
    for cap in (jl.SWEEPS, 30):
        ev, V, ran = jl.batched_eigh_leaf_cuda(A, return_sweeps=True, sweeps=cap)
        rows.append(f"cap {cap}: sweeps run {int(ran.min())}-{int(ran.max())}, eigenvalues "
                    "{:.3f} of the bar, orthonormality {:.2e}".format(*accuracy(A, ev, V)))
    rows.append("vendor: eigenvalues {:.3f} of the bar, orthonormality {:.2e}".format(
        *accuracy(A, *torch.linalg.eigh(A))))
    print(f"{label}: " + "; ".join(rows), flush=True)


def singles(jl):
    import torch

    for m in SINGLES:
        A = torch.tensor(smoke.random_sym(1, m, seed=m), device="cuda")
        _, _, ran = jl.batched_eigh_leaf_cuda(A, return_sweeps=True)
        t_k = smoke.cuda_times(lambda: jl.batched_eigh_leaf_cuda(A), reps=5)
        t_l = smoke.cuda_times(lambda: torch.linalg.eigh(A), reps=5)
        print(f"one matrix [1,{m},{m}]: {int(ran)} sweeps, leaf kernel {smoke.spread(t_k)}, "
              f"torch.linalg.eigh {smoke.spread(t_l)}, kernel/eigh "
              f"{np.median(t_k) / np.median(t_l):.3f}", flush=True)


def train_steps(reps=25):
    """``train_step_dp``'s three steps, ``reps`` times under each rule per
    turn, each solve's guard reading; a tripped Gram is kept and solved
    again under each leaf route (``chip_smoke.replay_trips``)."""
    import os
    import warnings

    import torch
    import torch.distributed as dist

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch import parallel as par
    from vivit_tpu_torch.kernels import jacobi
    from vivit_tpu_torch.parallel.launch import free_port
    from vivit_tpu_torch.utils import graphs

    os.environ["MASTER_ADDR"] = "127.0.0.1"
    os.environ["MASTER_PORT"] = str(free_port())
    dist.init_process_group("nccl", rank=0, world_size=1)
    model_fn, params = smoke.generic_model()
    X, y = smoke.port_batch(smoke.N)
    step = par.train_step_dp(model_fn, vtt.CrossEntropyLoss("mean"), None, smoke.TOP_K,
                             damping=1.0, lr=1.0, solver="dc", precision="highest",
                             deflate_ce_null=True)
    compared = {name: rule for name, rule in rules().items() if name in ("port", "parent")}
    solve, readings, kept, third, running = eigdc.eigh_dc, [], [], {}, [None]

    def read(H, **kw):
        asked = kw.get("return_info", False)
        ev, V, info = solve(H, **{**kw, "return_info": True})
        readings.append((float(info["bound"]), float(info["orth"]), bool(info["tripped"])))
        if readings[-1][2]:
            kept.append((H.detach().clone(), {k: v for k, v in kw.items() if k != "return_info"}))
        if len(readings) == 3:
            third[f"a run under the {running[0]}'s rule"] = H.detach().clone()
        return (ev, V, info) if asked else (ev, V)

    trips = {name: [0, 0] for name in compared}
    try:
        for name in ("port", "parent", "parent", "port"):
            graphs.clear()
            jacobi.route, eigdc.eigh_dc, running[0] = compared[name], read, name
            try:
                for _ in range(reps):
                    readings.clear()
                    p = params
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        for _ in range(3):
                            p, _ = step(p, X, y)
                    torch.cuda.synchronize()
                    trips[name][0] += sum(t for _, _, t in readings)
                    trips[name][1] += len(readings)
                    print(f"train_step_dp, {name}'s rule: (bound, orthonormality) " + ", ".join(
                        f"({b:.1e}, {o:.1e}{', tripped' if t else ''})" for b, o, t in readings),
                        flush=True)
            finally:
                jacobi.route, eigdc.eigh_dc = compared["port"], solve
        graphs.clear()
    finally:
        dist.destroy_process_group()
    print("train_step_dp trips: " + ", ".join(
        f"{name}'s rule {t} of {n} solves" for name, (t, n) in trips.items()), flush=True)
    if kept:
        smoke.replay_trips(kept, "train_step_dp")
        third["the first tripped run"] = kept[0][0]
    cross_solves(third, compared)


def cross_solves(grams, compared, seeds=range(16)):
    """Each of ``grams`` (a third step's Gram, by the run that made it)
    solved alone in eigenvector mode under each rule of ``compared``, with
    each of ``seeds`` (``eigh_dc``'s ``key``): the seeds at which its guard
    trips, so that a trip shows whether it follows the Gram, the leaf
    route or the draws."""
    import warnings

    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch.kernels import jacobi
    from vivit_tpu_torch.utils import graphs

    port = jacobi.route
    for made, H in grams.items():
        tripped = {}
        for name, rule in compared.items():
            graphs.clear()  # a replay keeps the rule it was captured with
            jacobi.route = rule
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    infos = [eigdc.eigh_dc(H, key=k, return_info=True)[2] for k in seeds]
            finally:
                jacobi.route = port
            tripped[name] = [k for k, info in zip(seeds, infos) if bool(info["tripped"])]
        graphs.clear()
        print(f"train_step_dp: the third Gram of {made}, solved with seeds {seeds[0]}-"
              f"{seeds[-1]}: the guard trips at " + "; ".join(
                  f"seeds {ks} ({len(ks)} of {len(seeds)}) under the {name}'s rule"
                  for name, ks in tripped.items()), flush=True)


def in_situ(jc, jl):
    import torch

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch.kernels import jacobi
    from vivit_tpu_torch.precision import _PRECISIONS, full_f32
    from vivit_tpu_torch.structured import gram_matrix_mixed
    from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt
    from vivit_tpu_torch.utils import graphs

    compared = rules()
    turns = [*compared, *reversed(compared)]
    routes = {"vendor": torch.linalg.eigh, "loop": loop_eigh,
              "window": lambda A: jc.batched_eigh_jacobi(A.contiguous()),
              "leaf": lambda A: jl.batched_eigh_leaf(A.contiguous())}
    model = smoke.port_model()
    loss = vtt.CrossEntropyLoss("mean")
    solves = []
    for n in (smoke.N, smoke.N_LARGE):
        X, y = smoke.port_batch(n)
        with full_f32():
            gram = gram_matrix_mixed(tapped_ggn_sqrt_vt(model, loss, X, y, deflate_ce_null=True),
                                     generic_precision=_PRECISIONS["bf16"])
        gram_d = smoke.deflated_gram(model, loss, X, y)[2]
        # the strip path routes its batches as solved outside any graph
        solves += [(f"eigvalsh_structured N={n}", lambda g=gram: eigdc.eigvalsh_dc(g),
                    gram.shape[0] >= eigdc.STRIP_MIN),
                   (f"eigh_topk N={n}", lambda g=gram_d: eigdc.eigh_dc(g),
                    gram_d.shape[0] >= eigdc.STRIP_MIN)]
    for label, solve, eager in solves:
        with smoke.eager_body(), full_f32():
            _, batches = smoke.recording_eigh(solve)
        totals = {"parent": 0.0, "port": 0.0}
        for A in batches:
            b, m = A.shape[0], A.shape[-1]
            ways = {name: compared[name](A.shape, A.dtype, A.device, eager)
                    for name in ("parent", "port")}
            on_leaf = "leaf" in (ways["port"], compared["kernel everywhere"](
                A.shape, A.dtype, A.device))
            tried = {"vendor", *ways.values(), *(("leaf",) if on_leaf else ())}
            if b > 1 and ways["port"] == "vendor":
                tried.add("loop")
            times = {name: smoke.cuda_times(lambda: routes[name](A), reps=3, warmup=1)
                     for name in sorted(tried)}
            for name, way in ways.items():
                totals[name] += np.median(times[way])
            if on_leaf:
                sweep_caps(jl, A, f"{label} in situ [{b},{m},{m}]")
            print(f"{label} in situ [{b},{m},{m}]: " + ", ".join(
                f"{name} {smoke.spread(t)}" for name, t in times.items())
                + f"; route: parent {ways['parent']}, port {ways['port']}", flush=True)
        print(f"{label} in situ, {len(batches)} batches: the parent's routes "
              f"{totals['parent']:.3f} ms, the port's {totals['port']:.3f} ms", flush=True)
        solve_ms = {name: [] for name in compared}
        for name in turns:
            jacobi.route = compared[name]
            try:
                with smoke.eager_body(), full_f32():
                    solve_ms[name] += smoke.cuda_times(solve, reps=1, warmup=1)
            finally:
                jacobi.route = compared["port"]
        print(f"{label} eigensolve (eager body, CUDA events around one call after a "
              "warm-up, in turns): " + ", ".join(
                  f"{name} {[round(t, 3) for t in ms]} ms" for name, ms in solve_ms.items()),
              flush=True)

    X, y = smoke.port_batch(smoke.N)
    calls = {
        f"eigvalsh_structured N={smoke.N} (headline)": lambda: vtt.eigvalsh_structured(
            model, loss, X, y, eig_backend="dc", **smoke.HEADLINE),
        f"eigh_topk N={smoke.N}": lambda: vtt.eigh_topk(
            model, loss, X, y, smoke.TOP_K, solver="dc", **smoke.HEADLINE),
    }
    for label, call in calls.items():
        call_ms = {name: [] for name in compared}
        for name in turns:
            graphs.clear()
            jacobi.route = compared[name]
            try:
                smoke.untripped(call, label)  # the capture under this rule
            finally:
                jacobi.route = compared["port"]
            call_ms[name] += smoke.cuda_times(call, reps=5, warmup=1)
        graphs.clear()
        base = np.median(call_ms["parent"])
        print(f"{label} replayed (CUDA events around one call, two turns of 5 each), "
              "captured under each rule: " + ", ".join(
                  f"{name}: {smoke.spread(ms)} ({np.median(ms) / base:.3f} of the "
                  "parent's)" for name, ms in call_ms.items()), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_eigh_routes: no CUDA device", file=sys.stderr)
        return 2
    from vivit_tpu_torch.kernels import jacobi_cuda as jc
    from vivit_tpu_torch.kernels import jacobi_leaf_cuda as jl
    from vivit_tpu_torch.kernels import toolchain

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    toolchain.build("jacobi")
    toolchain.build("jacobi_leaf")
    try:
        kernel_sweep(jc)
        leaf_sweep()
        in_situ(jc, jl)
        singles(jl)
        train_steps()
    except smoke.SmokeFailure as exc:
        print(f"torch_eigh_routes: FAIL: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
