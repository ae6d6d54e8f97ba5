#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vivit_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it runs:

1. **Card**: ``nvidia-smi`` name and power limit, then the build of the
   Jacobi kernel from ``vivit_tpu_torch/csrc/jacobi.cu`` (``nvcc``, sm_90a).
2. **Kernel against its plain version** on the card at the window shapes of
   the eigensolver, plus two degenerate inputs; the sweeps the kernel ran
   (its exact early exit) against those of the plain version under the same
   rule; times of the kernel, its plain version and ``torch.linalg.eigh`` on
   the same batch (CUDA events around 10 calls back to back and around one
   call, median), beside the bound on the sweeps run and on all 12.
   Then a **shape sweep** for the dispatch envelope: the kernel against
   ``torch.linalg.eigh`` at ``b in {1, 8, 37, 64}`` x ``m in {32, 48, 64}``,
   ``b*m <= 2048``, one line per shape.
3. **Main path**: ``eigvalsh_structured`` on full-width CIFAR-10 3c3d at
   N=128 with the headline settings (bf16 Gram, CE deflation, dc
   eigensolver).  Weights: ``cnn3c3d_flax_params(seed=0)`` (numpy) through
   ``params_from_flax``; data: numpy ``default_rng(0)``.  Checks the kernel
   launch count, the guard, the structural zeros, and both the deflated
   Gram's dc eigenvalues and the entry's returned spectrum against float64;
   runs the two window batches of that solve again through the kernel and
   its plain version (equal sweeps) and times them beside
   ``torch.linalg.eigh``; times the step and its three stages.
4. **N=128 eigenpairs**: ``eigh_topk(k=10, solver="dc")`` with the same
   settings (the bf16 Gram, deflated at the Gram level to 1152², the dc
   solver's chain path in eigenvector mode): 6 Jacobi launches, the guard,
   the top-10 eigenvalues, Gram-space residuals, the full 1152 basis and the
   back-projected parameter-space vectors against float64; the six window
   batches through the kernel and its plain version, timed beside
   ``torch.linalg.eigh``; then ``refine_eigh`` on the same Gram, warm-started
   from the dc basis (2 launches).
5. **N=512 spectrum**: ``eigvalsh_structured`` with the headline settings at
   N=512 (4608², the strip path): 0 Jacobi launches (its w=64 windows are
   outside the kernel's envelope), the guard, 0/4608 float64 violations, 512
   structural zeros.
6. **N=512 eigenpairs**: ``eigh_topk`` at N=512 (the strip path in
   eigenvector mode), the checks of phase 4.
7. **Times**: each new entry's call (median of 3 after a warm-up, host
   clock around a synchronised call; the N=512 eigenpairs one call) and its
   stages on CUDA events; one
   profiled N=512 eigenpair call; ``torch.linalg.eigh`` on each batch shape
   the N=512 eigenpair solve hands ``batched_eigh``.
8. **Newton step**: ``newton_step_structured(k=10, damping=1.0)`` at N=128
   with the headline settings, ``solver="lobpcg"`` (the JAX package's bench
   leg, ``bench.py:181-190``) and ``solver="dc"``: 0 and 6 Jacobi launches,
   LOBPCG's iteration count, and against an oracle (the step's own Gram,
   the top-10 of the deflated Gram from float64 ``torch.linalg.eigh``):
   the top-10 eigenvalues, the step, γ and λ, LOBPCG's residuals against
   its stopping rule (:func:`newton_gates`); the dc
   step's six window batches through the kernel and its plain version;
   each step's call time (median of 5) and its six stages on CUDA events;
   one profiled lobpcg call with its host syncs.
9. **Reference classes on a model function**: ``EigvalshComputation`` and
   ``EighComputation`` (``keep_top_k(10)``) at N=128 with the headline
   settings (``eig_backend="dc"``, Gram-level CE deflation of the 1280²
   Gram) on the plain function ``functional_call(CNN3c3d(), params, (x,))``,
   so the generic V-transform runs: 2 and 6 Jacobi launches, the guard,
   the spectrum against float64 of its own deflated Gram (0 violations,
   128 structural zeros), the eigenpair bars, the window batches through
   kernel and plain version; the generic and the tapped engines' f32 Grams
   on the same batch (engine agreement); Monte-Carlo factors
   (``mc_samples=1, key=0``) bit-equal over two calls under deterministic
   cuDNN and equal, up to the column scale, on a 64-sample sub-batch; call
   times, stages, peak memory and one profiled call.
10. **Streamed memory mode** (``vivit_tpu_torch.chunked``) on the same
    model function: the streamed f32 Gram at N=128 against the in-memory
    one (54 backward passes); ``eigvalsh_streamed`` at N=128 (2 launches,
    the spectrum against float64 of its own Gram) and N=512 (the strip
    path, 0 launches, 0/5120 violations, peak memory below the in-memory
    deflated Vᵀ's 16.50 GB, stages on CUDA events; the streamed and the
    in-memory f32 Grams and their peaks); ``eigh_topk_streamed`` (6
    launches, the eigenpair bars) and ``newton_step_streamed`` (6 launches,
    the float64 pipeline on its own Gram, the deviation from the in-memory
    step) at N=128, k=10.
11. **Gram primitives and ``conv_vt_dtype``**: ``gram_sqrt_ggn`` against
    the generic Gram, ``gram_batch_grad`` (centered and not) against float64
    Grams of the same gradients, the headline Gram with
    ``conv_vt_dtype=torch.bfloat16`` bit-equal to the one without.
12. **Matrix-free**: the GGN and Hessian-vector products at N=128 against
    float64 (and the GGN product under the default TF32 flags, printed);
    ``GGNLinearOperator`` over 576 images (its determinism check on the
    card), ``host_stream`` against the on-device matvec; the device Lanczos
    (``ncv=128``) on one batch against λmax; the Lanczos density
    (``ncv=64``, boundaries 0 and ARPACK's λmax) with mass within 5% of 1.
13. **Data parallel** (``vivit_tpu_torch.parallel``) in an NCCL group of
    world size 1 made in this process (``MASTER_ADDR=127.0.0.1``, a free
    port), 3c3d at N=128, headline settings: ``eigvalsh_dp_structured`` (2
    launches, 0/1280 violations against float64 of its own Gram, 128 zeros,
    within the eigenvalue bar of ``eigvalsh_structured``) and the bare
    ``all_to_all_single``/``all_reduce`` of its call; ``eigvalsh_dp`` on the
    model function (2 launches); ``eigh_dp`` (k_top: 6 launches and the
    eigenpair bars; the criterion path's eigenvalues);
    ``directional_derivatives_dp`` against ``directional_derivatives_topk``
    (BASELINE's γ/λ bars); ``newton_step_dp_structured`` (dc, 6 launches)
    against float64 on its own Gram and against ``newton_step_structured``;
    ``eigvalsh_streamed_dp`` (45 backward passes, 2 launches, its f32 Gram
    against the in-memory ``sharded_gram``); three ``train_step_dp`` steps
    lowering the loss; every dc solve's window batches through the kernel
    and its plain version; each builder's call time.
14. The call times of the new entries, the launches of each path, a JSON
    line of the kernels, then ``{"ok": true, "device": ...}`` last.

Any failed check exits non-zero.  Without a CUDA device it exits 2 and
prints no result.
"""

import json
import subprocess
import sys
import time
import warnings
from contextlib import contextmanager

import numpy as np

N = 128
NUM_CLASSES = 10
KERNEL_SHAPES = [(37, 32), (36, 32), (13, 32), (16, 48), (32, 64)]
HEADLINE_SHAPES = [(37, 32), (36, 32)]  # the window solves of one n=1152 solve
SWEEP_SHAPES = [(b, m) for m in (32, 48, 64) for b in (1, 8, 37, 64) if b * m <= 2048]
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
RTOL, ATOL = 1e-4, 5e-6
N_LARGE = 512
TOP_K = 10
# eigenpair bars (BASELINE.md): G e = λ e; parameter-space orthonormality;
# sign-invariant match of the vectors
RES_RTOL, RES_ATOL = 5e-4, 1e-5
ORTH_RTOL, ORTH_ATOL = 1e-3, 2e-4
VEC_RTOL, VEC_ATOL = 2e-2, 2e-3
HEADLINE = dict(precision="highest", gram_precision="bf16", deflate_ce_null=True)
# BASELINE.md: the Newton step rtol 1e-5 / atol 1e-5, γ atol 1e-4, λ atol
# 1e-5 (atols scaled by max(max|oracle|, 1)); the lobpcg step at the JAX
# package's recorded lobpcg+deflate deviation, 7.7e-4 (tests/test_engines.py)
NEWTON_RTOL, NEWTON_ATOL, GAMMA_ATOL, LAMBDA_ATOL = 1e-5, 1e-5, 1e-4, 1e-5
LOBPCG_STEP_ATOL = 7.7e-4
LOBPCG_ITERS = 100  # topk_eigh's default lobpcg_iters
# ‖G_generic − G_tapped‖_F/‖G_tapped‖_F of the f32 Grams: f32 summation noise,
# the bar of tests/test_torch_port_ggn.py (ENGINE_BAR)
ENGINE_BAR = 1e-5
# a 64-sample sub-batch's Monte-Carlo columns against the full batch's (times
# the column scale √2), relative to the leaf's largest entry
MC_SUB_RTOL = 1e-5


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps, warmup=2, calls=1):
    """Median time of one call of ``fn`` in ms: CUDA events around ``calls``
    back-to-back calls, over ``calls``, median of ``reps`` such runs.  With
    ``calls=1`` the events also hold the host's time before the launch."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def random_sym(b, m, seed):
    A = np.random.default_rng(seed).normal(size=(b, m, m)).astype(np.float32)
    return (A + A.transpose(0, 2, 1)) / 2


def check_eigh(A, ev, V, label):
    """Eigenvalues within 1e-4 of float64; ‖AV − VΛ‖_F < 1e-3 and
    max|VᵀV − I| < 1e-4 per matrix."""
    import torch

    A64 = A.double()
    ref = torch.linalg.eigvalsh(A64)
    err = (ev.double() - ref).abs().max().item()
    check(err < 1e-4, f"{label}: eigenvalues {err:.2e} off float64")
    V64 = V.double()
    res = torch.linalg.matrix_norm(A64 @ V64 - V64 * ev.double()[:, None, :])
    eye = torch.eye(A.shape[-1], dtype=torch.float64, device=A.device)
    orth = (V64.transpose(-1, -2) @ V64 - eye).abs().amax(dim=(-2, -1))
    check(res.max().item() < 1e-3, f"{label}: residual {res.max().item():.2e}")
    check(orth.max().item() < 1e-4, f"{label}: orthonormality {orth.max().item():.2e}")
    return ref, err


def phase_kernel(jc):
    """Kernel against plain version and float64; returns the JSON fields."""
    import torch

    max_err = 0.0
    timing = {}
    for b, m in KERNEL_SHAPES:
        A = torch.tensor(random_sym(b, m, seed=b * 100 + m), device="cuda")
        ev, V, sw = jc.batched_eigh_jacobi_cuda(A, return_sweeps=True)
        ev_p, _, sw_p = jc.batched_eigh_jacobi_plain(A, exit_early=True,
                                                     return_sweeps=True)
        torch.cuda.synchronize()
        ref, err64 = check_eigh(A, ev, V, f"kernel [{b},{m},{m}]")
        norm = ref.abs().amax(dim=-1)
        gap = (ev - ev_p).abs().amax(dim=-1)
        check(bool((gap <= 1e-5 * norm).all()),
              f"[{b},{m},{m}]: kernel and plain differ by {gap.max().item():.2e}")
        max_err = max(max_err, gap.max().item())
        most, least, most_p = int(sw.max()), int(sw.min()), int(sw_p.max())
        check(abs(most - most_p) <= 1,
              f"[{b},{m},{m}]: kernel ran {most} sweeps, plain {most_p}")
        line = (f"kernel [{b},{m},{m}]: max|kernel-plain| {gap.max().item():.3e}, "
                f"max|kernel-f64| {err64:.3e}, sweeps run {least}-{most} "
                f"(plain {int(sw_p.min())}-{most_p})")
        if (b, m) in HEADLINE_SHAPES:
            t_k = cuda_ms(lambda: jc.batched_eigh_jacobi_cuda(A), reps=30, calls=10)
            t_k1 = cuda_ms(lambda: jc.batched_eigh_jacobi_cuda(A), reps=30)
            t_p = cuda_ms(lambda: jc.batched_eigh_jacobi_plain(A, exit_early=True),
                          reps=3, warmup=1)
            t_l = cuda_ms(lambda: torch.linalg.eigh(A), reps=30, calls=10)
            t_l1 = cuda_ms(lambda: torch.linalg.eigh(A), reps=30)
            # the bound on the sweeps each matrix ran, and on all 12
            bound, by = jc.bound_ms(b, m, int(sw.sum()), PEAK_F32_FLOPS, PEAK_BYTES)
            bound12, _ = jc.bound_ms(b, m, b * jc.SWEEPS, PEAK_F32_FLOPS, PEAK_BYTES)
            timing[(b, m)] = (t_k, t_p, t_l, bound, by, most)
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.3f} ms, "
                     f"torch.linalg.eigh {t_l:.4f} ms (10 calls back to back; one "
                     f"call alone: kernel {t_k1:.4f} ms, torch.linalg.eigh {t_l1:.4f} ms), "
                     f"bound {bound:.6f} ms ({by}, {int(sw.sum())} matrix-sweeps), "
                     f"12-sweep bound {bound12:.6f} ms")
        print(line, flush=True)

    # degenerate inputs: tau == 0 everywhere at the start, and the skip
    m = 32
    A = torch.full((1, m, m), 0.5, device="cuda") + 1.5 * torch.eye(m, device="cuda")
    ev, V = jc.batched_eigh_jacobi_cuda(A)
    torch.cuda.synchronize()
    check_eigh(A, ev, V, "kernel 0.5*J + 1.5*I")
    d = torch.tensor(np.random.default_rng(3).normal(size=(2, m)).astype(np.float32),
                     device="cuda")
    ev, V = jc.batched_eigh_jacobi_cuda(torch.diag_embed(d))
    torch.cuda.synchronize()
    check(torch.equal(ev, torch.sort(d, dim=-1).values), "diagonal input changed")
    check(torch.equal(V.abs().sum(dim=1), torch.ones_like(d)),
          "diagonal input: eigenvectors are not a permutation")
    print("kernel degenerate cases (tau == 0, diagonal skip): ok", flush=True)
    return max_err, timing


def phase_shape_sweep(jc):
    """Kernel against ``torch.linalg.eigh`` over the envelope's shapes (data
    for the H100 dispatch decision; the dispatch does not read it)."""
    import torch

    for b, m in SWEEP_SHAPES:
        A = torch.tensor(random_sym(b, m, seed=b * 1000 + m), device="cuda")
        ev, V, sw = jc.batched_eigh_jacobi_cuda(A, return_sweeps=True)
        torch.cuda.synchronize()
        check_eigh(A, ev, V, f"shape sweep [{b},{m},{m}]")
        t_k = cuda_ms(lambda: jc.batched_eigh_jacobi_cuda(A), reps=10, calls=10)
        t_l = cuda_ms(lambda: torch.linalg.eigh(A), reps=10, calls=10)
        print(f"shape sweep [{b},{m},{m}]: kernel {t_k:.4f} ms, torch.linalg.eigh "
              f"{t_l:.4f} ms, kernel/eigh {t_k / t_l:.3f}, sweeps run "
              f"{int(sw.min())}-{int(sw.max())}", flush=True)


def phase_main_path(jc):
    import torch

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch.convert import params_from_flax
    from vivit_tpu_torch.eig import full_eigh
    from vivit_tpu_torch.kernels.jacobi import jacobi_supported
    from vivit_tpu_torch.models import cnn3c3d_flax_params
    from vivit_tpu_torch.precision import _PRECISIONS, full_f32
    from vivit_tpu_torch.structured import gram_matrix_mixed
    from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt

    model = vtt.CNN3c3d(NUM_CLASSES)
    model.load_state_dict(params_from_flax(cnn3c3d_flax_params(seed=0)))
    model = model.to("cuda").eval()
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    X_np = rng.normal(size=(N, 32, 32, 3)).astype(np.float32)
    y_np = rng.integers(0, NUM_CLASSES, size=(N,)).astype(np.int32)
    X = torch.tensor(X_np, device="cuda")
    y = torch.tensor(y_np, device="cuda")
    loss = vtt.CrossEntropyLoss("mean")
    headline = dict(precision="highest", gram_precision="bf16",
                    eig_backend="dc", deflate_ce_null=True)

    def step(**overrides):
        kw = dict(headline, **overrides)
        return vtt.eigvalsh_structured(model, loss, X, y, return_eig_info=True, **kw)

    step()  # warm-up
    torch.cuda.synchronize()
    jc.LAUNCHES = 0
    (evals,), (info,) = step()
    torch.cuda.synchronize()
    launches = jc.LAUNCHES
    print(f"main path: 3c3d ({n_params} parameters) N={N}, "
          f"{evals.numel()} eigenvalues, Jacobi launches {launches}, "
          f"guard tripped {bool(info['tripped'])} (bound "
          f"{float(info['bound']):.2e}, orth {float(info['orth']):.2e})", flush=True)
    check(launches == 2, f"expected 2 Jacobi launches per solve, got {launches}")
    check(not bool(info["tripped"]), "the eigdc guard tripped: dc path not exercised")
    check(evals.numel() == N * NUM_CLASSES, f"{evals.numel()} eigenvalues")
    check(bool(torch.isfinite(evals).all()), "non-finite eigenvalues")
    n_zero = int((evals == 0).sum())
    check(n_zero == N, f"{n_zero} exact zeros, expected {N}")

    # the deflated Gram's dc eigenvalues against float64, keeping the window
    # batches that the solve hands the kernel
    with full_f32():
        vt = tapped_ggn_sqrt_vt(model, loss, X, y, deflate_ce_null=True)
        gram = gram_matrix_mixed(vt, generic_precision=_PRECISIONS["bf16"])
        windows = []
        solve = eigdc.batched_eigh

        def recording(A):
            if jacobi_supported(A.shape, A.dtype):
                windows.append(A.clone())
            return solve(A)

        eigdc.batched_eigh = recording
        try:
            ev_dc = eigdc.eigvalsh_dc(gram)
        finally:
            eigdc.batched_eigh = solve
    ref = torch.linalg.eigvalsh(gram.double())
    err = (ev_dc.double() - ref).abs()
    tol = ATOL * ref.abs().max() + RTOL * ref.abs()
    ratio = (err / tol).max().item()
    print(f"deflated Gram {tuple(gram.shape)}: dc vs float64 max err/tol {ratio:.3f}, "
          f"{int((err > tol).sum())} violations", flush=True)
    check(ratio <= 1.0, f"dc eigenvalues off float64 (max err/tol {ratio:.2f})")
    check(len(windows) == 2, f"{len(windows)} window batches, expected 2")
    for A in windows:
        b, m, _ = A.shape
        ev, V, sw = jc.batched_eigh_jacobi_cuda(A, return_sweeps=True)
        ev_p, V_p, sw_p = jc.batched_eigh_jacobi_plain(A, exit_early=True,
                                                       return_sweeps=True)
        torch.cuda.synchronize()
        check(torch.equal(sw, sw_p), f"main-path window [{b},{m},{m}]: sweeps differ")
        gap = max((ev - ev_p).abs().max().item(), (V - V_p).abs().max().item())
        t_k = cuda_ms(lambda: jc.batched_eigh_jacobi_cuda(A), reps=30, calls=10)
        t_l = cuda_ms(lambda: torch.linalg.eigh(A), reps=30, calls=10)
        print(f"main-path window [{b},{m},{m}]: sweeps run {int(sw.min())}-{int(sw.max())}, "
              f"max|kernel-plain| {gap:.3e}, kernel {t_k:.4f} ms, torch.linalg.eigh "
              f"{t_l:.4f} ms (10 calls back to back)", flush=True)
    # the entry's own output: N structural zeros joined to the same spectrum
    ref_all = torch.sort(torch.cat([ref.new_zeros(N), ref])).values
    err = (evals.double() - ref_all).abs()
    tol = ATOL * ref_all.abs().max() + RTOL * ref_all.abs()
    ratio = (err / tol).max().item()
    print(f"main path {evals.numel()} eigenvalues vs float64: max err/tol {ratio:.3f}, "
          f"{int((err > tol).sum())} violations", flush=True)
    check(ratio <= 1.0, f"main-path eigenvalues off float64 (max err/tol {ratio:.2f})")

    (ev32,), (info32,) = step(gram_precision=None)
    top = evals[-20:].double()
    dev = ((top - ev32[-20:].double()).abs() / ev32[-20:].double().abs()).max().item()
    print(f"top-20 relative deviation bf16 Gram vs f32 Gram: {dev:.3e}", flush=True)

    # per-step time and its three stages (CUDA events)
    splits = []
    for i in range(6):
        ev_t = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with full_f32():
            ev_t[0].record()
            vt = tapped_ggn_sqrt_vt(model, loss, X, y, deflate_ce_null=True)
            ev_t[1].record()
            gram = gram_matrix_mixed(vt, generic_precision=_PRECISIONS["bf16"])
            ev_t[2].record()
            ev_d, _ = full_eigh(gram, backend="dc", eigenvectors=False)
            torch.sort(torch.cat([torch.zeros(N, device="cuda"), ev_d]))
            ev_t[3].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if i:  # the first is a warm-up
            splits.append([ev_t[k].elapsed_time(ev_t[k + 1]) for k in range(3)] + [wall])
    vt_ms, gram_ms, eig_ms, wall_ms = np.median(np.asarray(splits), axis=0)
    steps = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    print(f"main path step: {np.median(steps):.3f} ms median of 5 "
          f"(eigvalsh_structured, host clock); stages (CUDA events, median of 5): "
          f"V-transform {vt_ms:.3f} ms, Gram {gram_ms:.3f} ms, "
          f"eigensolve {eig_ms:.3f} ms, sum {vt_ms + gram_ms + eig_ms:.3f} ms, "
          f"host clock {wall_ms:.3f} ms", flush=True)
    profile_step(step)
    return launches


def profile_step(step, top=12, syncs=False):
    """One main-path step under ``torch.profiler``: device busy share, kernel
    launches, and the kernels that take the most device time; with
    ``syncs``, also the host syncs and where they come from
    (:func:`print_host_syncs`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        print("profile: the profiler saw no device events; busy share not measured",
              flush=True)
        return
    print(f"profile (one step under the profiler, {wall:.3f} ms host clock): "
          f"{sum(e.count for e in kernels)} kernel launches, device busy "
          f"{busy:.3f} ms = {busy / wall:.1%} of the step", flush=True)
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    shown = ranked[:top] + [e for e in ranked[top:] if "jacobi_kernel" in e.key]
    for e in shown:
        print(f"  device {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
              f"{e.key[:100]}", flush=True)
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"  host   {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:6d}x  "
              f"{e.key[:100]}", flush=True)
    if syncs:
        print_host_syncs(prof, step)


SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync",
               "aten::_local_scalar_dense")


def print_host_syncs(prof, step, top=12):
    """The host syncs of a profiled call (runtime synchronisations, copies,
    scalar reads of device tensors, device-to-host copies), then where they
    come from: one more call of ``step`` under PyTorch's sync debug mode,
    whose warnings carry the Python line that synchronised."""
    import os
    from collections import Counter

    import torch
    from torch.autograd import DeviceType

    counts = Counter(e.name for e in prof.events() if e.name in SYNC_EVENTS)
    dtoh = sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA and "DtoH" in e.name)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    root = os.path.dirname(os.path.abspath(__file__))
    where = Counter(f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message))
    print(f"  host syncs: {dict(counts)}, device-to-host copies {dtoh}; "
          f"{sum(where.values())} synchronizing operations by Python line:", flush=True)
    for line, count in where.most_common(top):
        print(f"    {count:5d}x {line}", flush=True)


def port_model():
    """Full-width 3c3d with ``cnn3c3d_flax_params(seed=0)`` on the card."""
    import vivit_tpu_torch as vtt
    from vivit_tpu_torch.convert import params_from_flax
    from vivit_tpu_torch.models import cnn3c3d_flax_params

    model = vtt.CNN3c3d(NUM_CLASSES)
    model.load_state_dict(params_from_flax(cnn3c3d_flax_params(seed=0)))
    return model.to("cuda").eval()


def port_batch(n):
    import torch

    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, size=(n,)).astype(np.int32)
    return torch.tensor(X, device="cuda"), torch.tensor(y, device="cuda")


def untripped(fn, label):
    """``fn()``, failing if an eigdc guard tripped inside it (the guard's
    warning is its only trace in an entry point's result)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    trips = [str(w.message) for w in caught if "guard tripped" in str(w.message)]
    check(not trips, f"{label}: {trips}")
    return out


def launches_of(jc, fn):
    """``(fn(), Jacobi launches during it)``, the count set to 0 just before."""
    import torch

    torch.cuda.synchronize()
    jc.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, jc.LAUNCHES


def recording_eigh(fn):
    """``(fn(), batches)``: every batch ``batched_eigh`` receives inside
    ``fn``, cloned, in call order."""
    from vivit_tpu_torch import eigdc

    batches = []
    solve = eigdc.batched_eigh

    def recording(A):
        batches.append(A.clone())
        return solve(A)

    eigdc.batched_eigh = recording
    try:
        out = fn()
    finally:
        eigdc.batched_eigh = solve
    return out, batches


def host_ms(fn, reps=3, warmup=True):
    """Median host-clock time of a synchronised call of ``fn``, after a
    warm-up (``warmup=False``: the caller has just run it)."""
    import torch

    if warmup:
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def stage_ms(stages, reps=3):
    """Median CUDA-event time of each stage over ``reps`` runs after a
    warm-up: ``stages`` is a list of ``(name, fn)``, each ``fn`` taking the
    previous stage's output."""
    import torch

    from vivit_tpu_torch.precision import full_f32

    runs = []
    for i in range(reps + 1):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        torch.cuda.synchronize()
        out = None
        with full_f32():
            events[0].record()
            for k, (_, fn) in enumerate(stages):
                out = fn(out)
                events[k + 1].record()
        torch.cuda.synchronize()
        if i:
            runs.append([events[k].elapsed_time(events[k + 1])
                         for k in range(len(stages))])
    med = np.median(np.asarray(runs), axis=0)
    return ", ".join(f"{name} {t:.3f} ms" for (name, _), t in zip(stages, med))


def deflated_gram(model, loss, X, y):
    """The raw bf16 Gram's Vᵀ, the CE complement and the Gram-level deflated
    Gram, built as ``eigh_topk`` builds them."""
    from vivit_tpu_torch import deflate
    from vivit_tpu_torch.precision import _PRECISIONS, full_f32
    from vivit_tpu_torch.structured import gram_matrix_mixed
    from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt

    with full_f32():
        vt = tapped_ggn_sqrt_vt(model, loss, X, y)
        gram = gram_matrix_mixed(vt, generic_precision=_PRECISIONS["bf16"])
        w = deflate.ce_null_complement(deflate.ce_probs(model, X))
        return vt, w, deflate.deflate_gram(gram, w)


def stacked(leaves):
    import torch

    return torch.cat([leaf.reshape(leaf.shape[0], -1) for leaf in leaves], dim=1).double()


def check_eigenpairs(label, evals, leaves, paths, vt, w, gram_d, ev_d, V_d):
    """The eigenpair bars on one path: the entry's top-k eigenvalues against
    float64; the dc solve of the same deflated Gram (``ev_d``, ``V_d``):
    Gram-space residuals, the full basis; the entry's parameter-space vectors:
    unit norm, orthonormality, and float64 eigenvectors sent through the same
    lift (the CE complement ``w``; ``None`` for a factor-level deflated
    ``vt``, whose Gram is ``gram_d`` itself) and back-projection, up to
    sign."""
    import torch

    from vivit_tpu_torch.deflate import lift_gram_vecs
    from vivit_tpu_torch.linalg.eigh import backproject
    from vivit_tpu_torch.precision import full_f32

    n, k = gram_d.shape[0], TOP_K
    G = gram_d.double()
    ref_ev, ref_V = torch.linalg.eigh(G)
    lmax = ref_ev.abs().max()
    err = (evals.double() - ref_ev[-k:]).abs()
    tol = ATOL * lmax + RTOL * ref_ev[-k:].abs()
    ratio = (err / tol).max().item()
    check(ratio <= 1.0, f"{label}: top-{k} eigenvalues off float64 (max err/tol {ratio:.2f})")

    E, lam = V_d[:, -k:].double(), ev_d[-k:].double()
    res = torch.linalg.vector_norm(G @ E - E * lam, dim=0)
    res_ratio = (res / (RES_RTOL * lam.abs() + RES_ATOL * lmax)).max().item()
    check(res_ratio <= 1.0, f"{label}: Gram-space residual {res_ratio:.2f} of its bar")
    V = V_d.double()
    eye = torch.eye(n, dtype=torch.float64, device=V.device)
    orth = (torch.linalg.matrix_norm(V.T @ V - eye) / n ** 0.5).item()
    defect = (torch.linalg.matrix_norm(G @ V - V * ev_d.double())
              / torch.linalg.matrix_norm(G)).item()
    check(orth < 1e-4, f"{label}: basis orthonormality {orth:.2e}")
    check(defect < 5e-4, f"{label}: basis defect {defect:.2e}")

    P = stacked(leaves)
    norm_err = (P.norm(dim=1) - 1.0).abs().max().item()
    C = P @ P.T
    off = (C - torch.diag(torch.diagonal(C))).abs().max().item()
    check(norm_err <= 1e-5, f"{label}: parameter-space norms off 1 by {norm_err:.2e}")
    check(off <= ORTH_ATOL + ORTH_RTOL, f"{label}: |v_i^T v_j| up to {off:.2e}")
    with full_f32():
        ref_vecs = ref_V[:, -k:].float()
        if w is not None:  # Gram-level deflation: the raw Gram's vectors
            ref_vecs = lift_gram_vecs(ref_vecs, w)
        ref_leaves = backproject(vt, ref_vecs, None, paths)
    R = stacked(ref_leaves)
    sign = torch.sign((P * R).sum(dim=1, keepdim=True))
    vec_ratio = ((P * sign - R).abs() / (VEC_ATOL + VEC_RTOL * R.abs())).max().item()
    check(vec_ratio <= 1.0, f"{label}: vectors off float64 ({vec_ratio:.2f} of the bar)")
    print(f"{label}: top-{k} eigenvalues vs float64 max err/tol {ratio:.3f}; Gram-space "
          f"residual {res_ratio:.3f} of 5e-4|λ|+1e-5λmax; full {n} basis "
          f"‖QᵀQ−I‖_F/√n {orth:.2e}, ‖GQ−QΛ‖_F/‖G‖_F {defect:.2e}; parameter space: "
          f"|‖v‖−1| {norm_err:.2e}, max|vᵢᵀvⱼ| {off:.2e}, vs float64 vectors "
          f"{vec_ratio:.3f} of rtol 2e-2/atol 2e-3", flush=True)


def phase_eigenpairs(jc, model, n, expect_launches):
    """``eigh_topk`` on one path, with its checks; returns ``(model inputs,
    launches, the dc solve of the deflated Gram, the batches it handed
    batched_eigh)``."""
    import torch

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch.precision import full_f32

    X, y = port_batch(n)
    loss = vtt.CrossEntropyLoss("mean")
    label = f"eigh_topk N={n}"

    def entry():
        return vtt.eigh_topk(model, loss, X, y, TOP_K, solver="dc", **HEADLINE)

    untripped(entry, label)  # warm-up
    (evals, leaves), launches = launches_of(jc, lambda: untripped(entry, label))
    vt, w, gram_d = deflated_gram(model, loss, X, y)
    with full_f32():
        (ev_d, V_d, info), batches = recording_eigh(
            lambda: eigdc.eigh_dc(gram_d, return_info=True))
    torch.cuda.synchronize()
    print(f"{label}: deflated Gram {tuple(gram_d.shape)}, Jacobi launches {launches}, "
          f"guard tripped {bool(info['tripped'])} (bound {float(info['bound']):.2e}, "
          f"orth {float(info['orth']):.2e}), top-{TOP_K} "
          f"{[round(v, 6) for v in evals.tolist()]}", flush=True)
    check(launches == expect_launches,
          f"{label}: expected {expect_launches} Jacobi launches, got {launches}")
    check(not bool(info["tripped"]), f"{label}: the eigdc guard tripped")
    check(evals.shape == (TOP_K,) and bool(torch.isfinite(evals).all()),
          f"{label}: eigenvalues {evals}")
    paths = [name for name, _ in model.named_parameters()]
    check_eigenpairs(label, evals, leaves, paths, vt, w, gram_d, ev_d, V_d)
    return (X, y, loss), launches, (gram_d, ev_d, V_d), batches


def time_windows(jc, batches, label, timed=True):
    """The Jacobi kernel on the window batches of a solve: against its plain
    version (equal sweeps), its time beside ``torch.linalg.eigh`` and its
    bound; returns the totals ``(kernel, eigh, bound, plain)`` ms (zeros
    without ``timed``, which checks alone)."""
    import torch

    from vivit_tpu_torch.kernels.jacobi import jacobi_supported

    totals = np.zeros(4)
    for A in (A for A in batches if jacobi_supported(A.shape, A.dtype)):
        b, m, _ = A.shape
        ev, V, sw = jc.batched_eigh_jacobi_cuda(A, return_sweeps=True)
        ev_p, V_p, sw_p = jc.batched_eigh_jacobi_plain(A, exit_early=True,
                                                       return_sweeps=True)
        torch.cuda.synchronize()
        check(torch.equal(sw, sw_p), f"{label} window [{b},{m},{m}]: sweeps differ")
        gap = max((ev - ev_p).abs().max().item(), (V - V_p).abs().max().item())
        check(gap <= 1e-5 * A.abs().max().item(),
              f"{label} window [{b},{m},{m}]: kernel and plain differ by {gap:.2e}")
        if not timed:
            print(f"{label} window [{b},{m},{m}]: sweeps run {int(sw.min())}-{int(sw.max())} "
                  f"(plain the same), max|kernel-plain| {gap:.3e}", flush=True)
            continue
        t_k = cuda_ms(lambda: jc.batched_eigh_jacobi_cuda(A), reps=30, calls=10)
        t_l = cuda_ms(lambda: torch.linalg.eigh(A), reps=30, calls=10)
        t_p = cuda_ms(lambda: jc.batched_eigh_jacobi_plain(A, exit_early=True),
                      reps=1, warmup=0)
        bound, by = jc.bound_ms(b, m, int(sw.sum()), PEAK_F32_FLOPS, PEAK_BYTES)
        totals += (t_k, t_l, bound, t_p)
        print(f"{label} window [{b},{m},{m}]: sweeps run {int(sw.min())}-{int(sw.max())}, "
              f"max|kernel-plain| {gap:.3e}, kernel {t_k:.4f} ms, torch.linalg.eigh "
              f"{t_l:.4f} ms (10 calls back to back), plain {t_p:.3f} ms, bound "
              f"{bound:.6f} ms ({by})", flush=True)
    return totals


def phase_refine(jc, gram_d, V_d):
    """``refine_eigh`` on the N=128 deflated Gram, warm-started from the dc
    basis; returns its launches."""
    import torch

    from vivit_tpu_torch.eigdc import refine_eigh

    ((ev, Q, res), batches), launches = launches_of(
        jc, lambda: recording_eigh(lambda: refine_eigh(gram_d, V_d)))
    ref = torch.linalg.eigvalsh(gram_d.double())
    err = (ev.double() - ref).abs()
    tol = ATOL * ref.abs().max() + RTOL * ref.abs()
    ratio = (err / tol).max().item()
    t = cuda_ms(lambda: refine_eigh(gram_d, V_d), reps=5)
    print(f"refine_eigh {tuple(gram_d.shape)} from the dc basis: Jacobi launches "
          f"{launches}, residual {float(res):.2e}, eigenvalues vs float64 max err/tol "
          f"{ratio:.3f}, {t:.3f} ms (CUDA events, median of 5)", flush=True)
    check(launches == 2, f"refine_eigh: expected 2 Jacobi launches, got {launches}")
    check(float(res) < 1e-4, f"refine_eigh: residual {float(res):.2e}")
    check(ratio <= 1.0, f"refine_eigh: eigenvalues off float64 (max err/tol {ratio:.2f})")
    win = time_windows(jc, batches, "refine_eigh")
    print(f"refine_eigh, its {launches} window launches: kernel {win[0]:.4f} ms, "
          f"torch.linalg.eigh {win[1]:.4f} ms, bound {win[2]:.6f} ms, plain "
          f"{win[3]:.3f} ms", flush=True)
    return launches


def phase_spectrum_large(jc, model):
    """``eigvalsh_structured`` at N=512 (the strip path); returns its
    launches and inputs."""
    import torch

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch.precision import _PRECISIONS, full_f32
    from vivit_tpu_torch.structured import gram_matrix_mixed
    from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt

    n = N_LARGE
    X, y = port_batch(n)
    loss = vtt.CrossEntropyLoss("mean")
    label = f"eigvalsh_structured N={n}"

    def entry():
        return vtt.eigvalsh_structured(model, loss, X, y, eig_backend="dc",
                                       return_eig_info=True, **HEADLINE)

    entry()  # warm-up
    ((evals,), (info,)), launches = launches_of(jc, entry)
    n_zero = int((evals == 0).sum())
    print(f"{label}: {evals.numel()} eigenvalues, {n_zero} exact zeros, Jacobi launches "
          f"{launches}, guard tripped {bool(info['tripped'])} (bound "
          f"{float(info['bound']):.2e}, orth {float(info['orth']):.2e})", flush=True)
    check(launches == 0, f"{label}: expected 0 Jacobi launches, got {launches}")
    check(not bool(info["tripped"]), f"{label}: the eigdc guard tripped")
    check(evals.numel() == n * NUM_CLASSES, f"{label}: {evals.numel()} eigenvalues")
    check(bool(torch.isfinite(evals).all()), f"{label}: non-finite eigenvalues")
    check(n_zero == n, f"{label}: {n_zero} exact zeros, expected {n}")

    with full_f32():
        vt = tapped_ggn_sqrt_vt(model, loss, X, y, deflate_ce_null=True)
        gram = gram_matrix_mixed(vt, generic_precision=_PRECISIONS["bf16"])
        ev_dc, info_dc = eigdc.eigvalsh_dc(gram, return_info=True)
    ref = torch.linalg.eigvalsh(gram.double())
    for name, got, want in (
            (f"deflated Gram {tuple(gram.shape)} dc", ev_dc, ref),
            (f"{label} {evals.numel()} eigenvalues",
             evals, torch.sort(torch.cat([ref.new_zeros(n), ref])).values)):
        err = (got.double() - want).abs()
        tol = ATOL * want.abs().max() + RTOL * want.abs()
        ratio = (err / tol).max().item()
        bad = int((err > tol).sum())
        print(f"{name} vs float64: max err/tol {ratio:.3f}, {bad}/{want.numel()} "
              "violations", flush=True)
        check(bad == 0, f"{name}: {bad} violations of float64")
    check(not bool(info_dc["tripped"]), f"deflated Gram {tuple(gram.shape)}: guard tripped")
    return launches, (X, y, loss)


def phase_times(jc, model, inputs_small, inputs_large, spectrum_inputs):
    """Times of the new entries and their stages, one profiled N=512
    eigenpair call, and ``torch.linalg.eigh`` on the N=512 eigenpair solve's
    batch shapes."""
    import torch

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import deflate, eigdc
    from vivit_tpu_torch.linalg.eigh import backproject
    from vivit_tpu_torch.precision import _PRECISIONS
    from vivit_tpu_torch.structured import gram_matrix_mixed
    from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt

    paths = [name for name, _ in model.named_parameters()]
    for X, y, loss in (inputs_small, inputs_large):
        n = X.shape[0]

        def entry():
            return vtt.eigh_topk(model, loss, X, y, TOP_K, solver="dc", **HEADLINE)

        def gram_stage(vt):
            gram = gram_matrix_mixed(vt, generic_precision=_PRECISIONS["bf16"])
            w = deflate.ce_null_complement(deflate.ce_probs(model, X))
            return vt, w, deflate.deflate_gram(gram, w)

        def solve_stage(state):
            vt, w, gram_d = state
            return vt, w, eigdc.eigh_dc(gram_d)[1][:, -TOP_K:]

        def backproject_stage(state):
            vt, w, vecs = state
            return backproject(vt, deflate.lift_gram_vecs(vecs, w), None, paths)

        # N=512: one timed call and one staged call, to keep the script short
        reps = 1 if n == N_LARGE else 3
        stages = stage_ms([
            ("V-transform", lambda _: tapped_ggn_sqrt_vt(model, loss, X, y)),
            ("Gram (raw, deflated at the Gram level)", gram_stage),
            ("eigensolve", solve_stage),
            ("lift and back-projection", backproject_stage)], reps=reps)
        print(f"eigh_topk N={n}: {host_ms(entry, reps=reps):.3f} ms median of {reps} (host "
              f"clock); stages (CUDA events, median of {reps}): {stages}", flush=True)

    X, y, loss = spectrum_inputs
    n = X.shape[0]

    def spectrum():
        return vtt.eigvalsh_structured(model, loss, X, y, eig_backend="dc", **HEADLINE)

    stages = stage_ms([
        ("V-transform", lambda _: tapped_ggn_sqrt_vt(model, loss, X, y,
                                                     deflate_ce_null=True)),
        ("Gram", lambda vt: gram_matrix_mixed(vt, generic_precision=_PRECISIONS["bf16"])),
        ("eigensolve", lambda gram: torch.sort(torch.cat([
            gram.new_zeros(n), eigdc.eigvalsh_dc(gram)])))])
    print(f"eigvalsh_structured N={n}: {host_ms(spectrum):.3f} ms median of 3 (host "
          f"clock); stages (CUDA events, median of 3): {stages}", flush=True)

    X, y, loss = inputs_large

    def eigenpairs():
        return vtt.eigh_topk(model, loss, X, y, TOP_K, solver="dc", **HEADLINE)

    print(f"profiled call: eigh_topk N={X.shape[0]}", flush=True)
    profile_step(eigenpairs)
    _, batches = recording_eigh(eigenpairs)
    shapes = {}
    for A in batches:
        shapes.setdefault(tuple(A.shape), A)
    counts = {s: sum(tuple(A.shape) == s for A in batches) for s in shapes}
    for shape, A in shapes.items():
        t = cuda_ms(lambda: torch.linalg.eigh(A), reps=5, warmup=1)
        print(f"eigh_topk N={X.shape[0]} batched_eigh {list(shape)} x{counts[shape]} per "
              f"solve: torch.linalg.eigh {t:.3f} ms (CUDA events, median of 5)",
              flush=True)


@contextmanager
def recorded(owner, name):
    """Inside the block, every call of ``owner.name`` appends ``(args,
    result)`` to the yielded list."""
    calls = []
    original = getattr(owner, name)

    def wrapper(*args, **kwargs):
        out = original(*args, **kwargs)
        calls.append((args, out))
        return out

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, original)


def newton_step(model, loss, X, y, solver, device=None):
    """The bench leg's ``newton_step_structured`` (k=10, damping 1, bf16
    Gram, CE deflation) with ``solver``; returns ``(step, Vᵀ, the arguments
    and result of its gammas_lambdas, its LOBPCG solves)``."""
    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import lobpcg, structured
    from vivit_tpu_torch.optim import utils as optim_utils

    with recorded(structured, "gram_matrix_mixed") as grams, \
            recorded(optim_utils, "gammas_lambdas") as derivs, \
            recorded(lobpcg, "lobpcg_standard") as solves:
        step = vtt.newton_step_structured(model, loss, X, y, TOP_K, damping=1.0,
                                          solver=solver, device=device, **HEADLINE)
    check(len(grams) == 1 and len(derivs) == 1, "one Gram and one γ/λ per step")
    return step, grams[0][0][0], derivs[0], solves


def newton_oracle(model, X, vt, derivs):
    """The step's own pipeline on its own bf16 Gram, with the top-k from
    float64 ``torch.linalg.eigh`` of the Gram-level deflated Gram (γ/λ and
    the coefficients in float64): ``(the deflated Gram's float64 spectrum,
    step, γ, λ)``."""
    import torch

    from vivit_tpu_torch import deflate
    from vivit_tpu_torch.optim.directional_damped_newton import newton_step_from_derivatives
    from vivit_tpu_torch.optim.utils import gammas_lambdas
    from vivit_tpu_torch.precision import full_f32

    (gram, _, _, v_t_g, s), _ = derivs
    paths = [name for name, _ in model.named_parameters()]
    with full_f32():
        w = deflate.ce_null_complement(deflate.ce_probs(model, X))
        ev, V = torch.linalg.eigh(deflate.deflate_gram(gram, w).double())
        ev_k, V_k = ev[-TOP_K:], deflate.lift_gram_vecs(V[:, -TOP_K:], w.double())
        gammas, lambdas = gammas_lambdas(gram.double(), ev_k, V_k, v_t_g.double(), s)
        step = newton_step_from_derivatives(vt, paths, ev_k.float(), V_k.float(),
                                            gammas.float(), lambdas.float(), 1.0)
    return ev, step, gammas, lambdas


def newton_gates(solver, step, derivs, oracle, solves):
    """The Newton phase's bars as ``{name: (max err / tol, gated)}`` (≤ 1
    passes): the top-k eigenvalues against float64; the step at BASELINE's
    Newton bar, for lobpcg at max|step − oracle| ≤ 7.7e-4·max(max|oracle|,
    1); γ up to sign and λ at BASELINE's bars.

    LOBPCG stops once every residual is below eps·10·n·(‖Gx‖ + θ), ~1e-3
    relative at n=1152, which leaves its vectors, and so γ and λ, outside
    BASELINE's bars against the float64 eigenvectors (the JAX package's own
    LOBPCG against its eigh too).  For lobpcg those two are printed; what is
    gated is its residuals against that rule (recomputed as the loop does)
    and γ, λ against the pipeline in float64 on its own eigenpairs."""
    import torch

    from vivit_tpu_torch.optim.utils import gammas_lambdas
    from vivit_tpu_torch.precision import full_f32

    ev64, step_o, gammas_o, lambdas_o = oracle
    (gram, evals, evecs, v_t_g, s), (gammas, lambdas) = derivs
    ref = ev64[-TOP_K:]
    ratios = {"top-10 eigenvalues": (((evals.double() - ref).abs() / (
        ATOL * ev64.abs().max() + RTOL * ref.abs())).max(), True)}
    scale = max(max(float(o.abs().max()) for o in step_o), 1.0)
    ratios["step"] = (max(
        ((g.double() - o.double()).abs()
         / (LOBPCG_STEP_ATOL * scale if solver == "lobpcg"
            else NEWTON_ATOL * scale + NEWTON_RTOL * o.double().abs())).max()
        for g, o in zip(step, step_o)), True)
    refs = [("", gammas_o, lambdas_o, solver != "lobpcg")]
    if solver == "lobpcg":
        (A, _), (theta, X, _) = solves[0]
        with full_f32():
            AX = A @ X
            resid = torch.linalg.vector_norm(AX - theta[None] * X, dim=0)
            rule = torch.finfo(A.dtype).eps * 10 * A.shape[0] * (
                torch.linalg.vector_norm(AX, dim=0) + theta)
        ratios["residual/stopping rule"] = ((resid / rule).max(), True)
        own = gammas_lambdas(gram.double(), evals.double(), evecs.double(),
                             v_t_g.double(), s)
        refs.append((" on its own eigenpairs", *own, True))
    for suffix, gammas_r, lambdas_r, gated in refs:
        sign = (gammas.double() * gammas_r).sum(dim=0).sign()
        for name, got, want, atol in (("γ", gammas.double() * sign, gammas_r, GAMMA_ATOL),
                                      ("λ", lambdas.double(), lambdas_r, LAMBDA_ATOL)):
            tol = atol * max(float(want.abs().max()), 1.0) + NEWTON_RTOL * want.abs()
            ratios[name + suffix] = (((got - want).abs() / tol).max(), gated)
    return {name: (float(r), gated) for name, (r, gated) in ratios.items()}


def newton_stages(model, loss, X, y, solver):
    """The Newton step's stages on CUDA events, built from the pieces
    ``newton_step_structured`` calls."""
    from vivit_tpu_torch import deflate
    from vivit_tpu_torch.eig import topk_eigh
    from vivit_tpu_torch.ggn import batch_grad
    from vivit_tpu_torch.optim.directional_damped_newton import newton_step_from_derivatives
    from vivit_tpu_torch.optim.utils import gammas_lambdas
    from vivit_tpu_torch.precision import _PRECISIONS
    from vivit_tpu_torch.structured import gram_matrix_mixed, vt_mat_prod_mixed
    from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt

    paths = [name for name, _ in model.named_parameters()]
    n = X.shape[0]

    def gram_stage(vt):
        gram = gram_matrix_mixed(vt, paths, generic_precision=_PRECISIONS["bf16"])
        w = deflate.ce_null_complement(deflate.ce_probs(model, X))
        return vt, gram, w, deflate.deflate_gram(gram, w)

    def solve_stage(state):
        vt, gram, w, gram_d = state
        evals, vecs = topk_eigh(gram_d, TOP_K, solver=solver)
        return vt, gram, evals, deflate.lift_gram_vecs(vecs, w)

    def vtg_stage(state):
        (vt, gram, evals, vecs), grads = state
        v_t_g = vt_mat_prod_mixed(vt, [grads[p] * n for p in paths], paths)
        return vt, gram, evals, vecs, v_t_g

    def step_stage(state):
        vt, gram, evals, vecs, v_t_g = state
        gammas, lambdas = gammas_lambdas(gram, evals, vecs, v_t_g, n)
        return newton_step_from_derivatives(vt, paths, evals, vecs, gammas, lambdas, 1.0)

    return stage_ms([
        ("V-transform", lambda _: tapped_ggn_sqrt_vt(model, loss, X, y)),
        ("Gram and Gram-level deflation", gram_stage),
        (f"top-{TOP_K} solve ({solver}, lifted)", solve_stage),
        ("per-sample gradients", lambda state: (state, batch_grad(model, loss, X, y))),
        ("Vᵀg", vtg_stage),
        ("γ/λ and back-projection", step_stage)], reps=5)


def phase_newton(jc, model):
    """``newton_step_structured`` at N=128, the bench leg (lobpcg) and the
    same step with the dc solver, against the float64 oracle; their
    launches, times, stages and a profiled lobpcg call.  Returns the
    launches per solver."""
    import vivit_tpu_torch as vtt

    X, y = port_batch(N)
    loss = vtt.CrossEntropyLoss("mean")
    launches, failed = {}, []
    for solver in ("lobpcg", "dc"):
        label = f"newton_step_structured N={N} ({solver})"
        untripped(lambda: newton_step(model, loss, X, y, solver), label)  # warm-up
        ((step, vt, derivs, solves), batches), launches[solver] = launches_of(
            jc, lambda: recording_eigh(lambda: untripped(
                lambda: newton_step(model, loss, X, y, solver), label)))
        ratios = newton_gates(solver, step, derivs, newton_oracle(model, X, vt, derivs),
                              solves)
        iters = [out[2] for _, out in solves]
        print(f"{label}: Jacobi launches {launches[solver]}, LOBPCG iterations {iters} "
              f"(of at most {LOBPCG_ITERS}), top-{TOP_K} "
              f"{[round(v, 6) for v in derivs[0][1].tolist()]}; against the float64 "
              "oracle, max err/tol: " + ", ".join(
                  f"{k} {v:.3f}" + ("" if gated else " (not gated)")
                  for k, (v, gated) in ratios.items()), flush=True)
        expect = 0 if solver == "lobpcg" else 6
        if launches[solver] != expect:
            failed.append(f"{label}: {launches[solver]} Jacobi launches, expected {expect}")
        if solver == "lobpcg" and not (len(iters) == 1 and iters[0] < LOBPCG_ITERS):
            failed.append(f"{label}: LOBPCG iterations {iters}")
        failed += [f"{label}: {k} at {v:.2f} of its bar"
                   for k, (v, gated) in ratios.items() if gated and v > 1.0]
        if solver == "dc":
            win = time_windows(jc, batches, label)
            print(f"{label}, its {launches[solver]} window launches: kernel {win[0]:.4f} ms, "
                  f"torch.linalg.eigh {win[1]:.4f} ms, bound {win[2]:.6f} ms, plain "
                  f"{win[3]:.3f} ms", flush=True)
    check(not failed, "; ".join(failed))

    for solver in ("lobpcg", "dc"):
        def call():
            return vtt.newton_step_structured(model, loss, X, y, TOP_K, damping=1.0,
                                              solver=solver, **HEADLINE)

        print(f"newton_step_structured N={N} ({solver}): {host_ms(call, reps=5):.3f} ms "
              "median of 5 (host clock); stages (CUDA events, median of 5): "
              f"{newton_stages(model, loss, X, y, solver)}", flush=True)
    print(f"profiled call: newton_step_structured N={N} (lobpcg)", flush=True)
    profile_step(lambda: vtt.newton_step_structured(
        model, loss, X, y, TOP_K, damping=1.0, solver="lobpcg", **HEADLINE), syncs=True)
    return launches


@contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms inside the block."""
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def generic_model():
    """3c3d as a plain model function over a params dict on the card (the
    module's own parameters stay unused on the CPU)."""
    from torch.func import functional_call

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch.convert import params_from_flax
    from vivit_tpu_torch.models import cnn3c3d_flax_params

    net = vtt.CNN3c3d(NUM_CLASSES)
    params = {name: p.to("cuda") for name, p in
              params_from_flax(cnn3c3d_flax_params(seed=0)).items()}
    return (lambda p, x: functional_call(net, p, (x,))), params


def check_spectrum(label, evals, gram_d, n):
    """The entry's spectrum against float64 ``eigvalsh`` of its own deflated
    Gram, the ``n`` structural zeros joined: 0 violations of the eigenvalue
    bar and exactly ``n`` zeros."""
    import torch

    ref = torch.linalg.eigvalsh(gram_d.double())
    ref_all = torch.sort(torch.cat([ref.new_zeros(n), ref])).values
    err = (evals.double() - ref_all).abs()
    tol = ATOL * ref_all.abs().max() + RTOL * ref_all.abs()
    ratio, bad, zeros = (err / tol).max().item(), int((err > tol).sum()), int((evals == 0).sum())
    print(f"{label}: {evals.numel()} eigenvalues vs float64 of its deflated Gram "
          f"{tuple(gram_d.shape)}: max err/tol {ratio:.3f}, {bad}/{evals.numel()} violations, "
          f"{zeros} exact zeros", flush=True)
    check(bool(torch.isfinite(evals).all()), f"{label}: non-finite eigenvalues")
    check(bad == 0, f"{label}: {bad} violations of float64")
    check(zeros == n, f"{label}: {zeros} exact zeros, expected {n}")


def phase_generic(jc):
    """The reference classes on a plain model function (the generic
    V-transform) at N=128 with the headline settings; engine agreement and
    the Monte-Carlo gates.  Returns the launches per class."""
    import torch

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import deflate, eigdc
    from vivit_tpu_torch.ggn import ggn_sqrt_vt
    from vivit_tpu_torch.gram import gram_matrix
    from vivit_tpu_torch.precision import _PRECISIONS, full_f32
    from vivit_tpu_torch.structured import gram_matrix_mixed
    from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt

    model_fn, params = generic_model()
    paths = list(params)
    X, y = port_batch(N)
    loss = vtt.CrossEntropyLoss("mean")
    settings = dict(eig_backend="dc", **HEADLINE)
    launches = {}

    # EigvalshComputation: the dc chain path in eigenvalue mode (2 windows)
    label = f"EigvalshComputation N={N} (model function)"
    eigvalsh = vtt.EigvalshComputation(model_fn, loss, **settings)

    def eigvalsh_call():
        return eigvalsh.compute(X, y, params=params)[0]

    untripped(eigvalsh_call, label)  # warm-up
    with recorded(deflate, "deflate_gram") as grams:
        (evals, batches), launches[label] = launches_of(
            jc, lambda: recording_eigh(lambda: untripped(eigvalsh_call, label)))
    gram_d = grams[0][1]
    with full_f32():
        _, info = eigdc.eigvalsh_dc(gram_d, return_info=True)
    print(f"{label}: Jacobi launches {launches[label]}, guard tripped "
          f"{bool(info['tripped'])} (bound {float(info['bound']):.2e}, orth "
          f"{float(info['orth']):.2e})", flush=True)
    check(launches[label] == 2, f"{label}: expected 2 Jacobi launches, got {launches[label]}")
    check(not bool(info["tripped"]), f"{label}: the eigdc guard tripped")
    check_spectrum(label, evals, gram_d, N)
    win = time_windows(jc, batches, label)
    print(f"{label}, its {launches[label]} window launches: kernel {win[0]:.4f} ms, "
          f"torch.linalg.eigh {win[1]:.4f} ms, bound {win[2]:.6f} ms, plain "
          f"{win[3]:.3f} ms", flush=True)

    # EighComputation: the dc chain path in eigenvector mode (6 windows)
    label = f"EighComputation N={N} (model function, keep_top_k({TOP_K}))"
    eigh = vtt.EighComputation(model_fn, loss, **settings)
    groups = [{"params": paths, "criterion": vtt.keep_top_k(TOP_K)}]

    def eigh_call():
        return eigh.compute(X, y, groups, params=params)

    untripped(eigh_call, label)  # warm-up
    with recorded(deflate, "deflate_gram") as grams:
        (((ev, leaves),), batches), launches[label] = launches_of(
            jc, lambda: recording_eigh(lambda: untripped(eigh_call, label)))
    info = eigh.get_eig_info(groups[0])
    print(f"{label}: Jacobi launches {launches[label]}, guard tripped "
          f"{bool(info['tripped'])} (bound {float(info['bound']):.2e}, orth "
          f"{float(info['orth']):.2e}), top-{TOP_K} {[round(v, 6) for v in ev.tolist()]}",
          flush=True)
    check(launches[label] == 6, f"{label}: expected 6 Jacobi launches, got {launches[label]}")
    check(not bool(info["tripped"]), f"{label}: the eigdc guard tripped")
    check(ev.shape == (TOP_K,), f"{label}: eigenvalues {ev}")
    gram_d = grams[0][1]
    with full_f32():
        vt = ggn_sqrt_vt(model_fn, loss, params, X, y)
        w = deflate.ce_null_complement(deflate.ce_probs(model_fn, X, params))
        ev_d, V_d = eigdc.eigh_dc(gram_d)
    check_eigenpairs(label, ev, leaves, paths, vt, w, gram_d, ev_d, V_d)
    win = time_windows(jc, batches, label)
    print(f"{label}, its {launches[label]} window launches: kernel {win[0]:.4f} ms, "
          f"torch.linalg.eigh {win[1]:.4f} ms, bound {win[2]:.6f} ms, plain "
          f"{win[3]:.3f} ms", flush=True)

    # engine agreement: the generic and the tapped f32 Grams of the same batch
    with full_f32():
        g_gen = gram_matrix(vt)
        g_tap = gram_matrix_mixed(tapped_ggn_sqrt_vt(port_model(), loss, X, y))
    rel = ((g_gen - g_tap).norm() / g_tap.norm()).item()
    print(f"engine agreement N={N}: generic vs tapped f32 Gram {tuple(g_gen.shape)}, "
          f"‖ΔG‖_F/‖G‖_F {rel:.3e} (bar {ENGINE_BAR:.0e})", flush=True)
    check(rel <= ENGINE_BAR, f"engine agreement {rel:.2e} above {ENGINE_BAR:.0e}")
    del vt, g_gen, g_tap

    # Monte-Carlo factors at full width: draws of (key, sample id) only
    with full_f32():
        f = model_fn(params, X)
        draws = loss.mc_draws(f, y, 1, 0, range(N))
        draws_sub = loss.mc_draws(f[:N // 2], y[:N // 2], 1, 0, range(N // 2))
        plain = [ggn_sqrt_vt(model_fn, loss, params, X, y, mc_samples=1, key=0)
                 for _ in range(2)]
        plain_diff = max((plain[0][k] - plain[1][k]).abs().max().item() for k in plain[0])
        del plain
        with deterministic_cudnn():
            a, b = (ggn_sqrt_vt(model_fn, loss, params, X, y, mc_samples=1, key=0)
                    for _ in range(2))
            sub = ggn_sqrt_vt(model_fn, loss, params, X, y, mc_samples=1, key=0,
                              subsampling=range(N // 2))
    equal = all(torch.equal(a[k], b[k]) for k in a)
    sub_err = max(((a[k][:, :N // 2] * 2 ** 0.5 - sub[k]).abs().max() / a[k].abs().max()).item()
                  for k in a)
    draws_equal = torch.equal(draws[:N // 2], draws_sub)
    print(f"Monte-Carlo factors N={N} (mc_samples=1, key=0): two calls bit-equal "
          f"{equal} under deterministic cuDNN (without: max|Δ| {plain_diff:.3e}); the 64-sample "
          f"sub-batch's draws equal the full batch's {draws_equal}, its columns ×√2 vs "
          f"the full batch's: max rel err {sub_err:.3e} (bar {MC_SUB_RTOL:.0e})", flush=True)
    check(equal, "Monte-Carlo V-transform: two calls differ")
    check(draws_equal, "Monte-Carlo draws depend on the batch")
    check(sub_err <= MC_SUB_RTOL, f"Monte-Carlo sub-batch columns off by {sub_err:.2e}")
    del a, b, sub

    # times, stages, peak memory, one profiled call
    for name, call in (("EigvalshComputation", eigvalsh_call), ("EighComputation", eigh_call)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        print(f"{name} N={N} (model function): {host_ms(call, reps=5):.3f} ms median of 5 "
              f"(host clock); peak memory {peak:.3f} GiB above the "
              f"{base / 2 ** 30:.3f} GiB held before the call", flush=True)
    module = port_model()

    def gram_stage(vt):
        gram = gram_matrix(vt, precision=_PRECISIONS["bf16"])
        w = deflate.ce_null_complement(deflate.ce_probs(model_fn, X, params))
        return vt, w, deflate.deflate_gram(gram, w)

    def solve_stage(state):
        vt, w, gram_d = state
        return vt, w, eigdc.eigh_dc(gram_d)[1][:, -TOP_K:]

    def backproject_stage(state):
        from vivit_tpu_torch.linalg.eigh import backproject

        vt, w, vecs = state
        return backproject(vt, deflate.lift_gram_vecs(vecs, w), None, paths)

    stages = stage_ms([
        ("generic V-transform", lambda _: ggn_sqrt_vt(model_fn, loss, params, X, y)),
        ("Gram (bf16) and Gram-level deflation", gram_stage),
        ("eigensolve (dc, eigenvectors)", solve_stage),
        ("lift and back-projection", backproject_stage)])
    print(f"EighComputation N={N} stages (CUDA events, median of 3): {stages}", flush=True)
    stages = stage_ms([
        ("tapped V-transform (the same batch, nn.Module)",
         lambda _: tapped_ggn_sqrt_vt(module, loss, X, y)),
        ("eigensolve (dc, eigenvalues, the deflated Gram)",
         lambda _: eigdc.eigvalsh_dc(gram_d))])
    print(f"N={N} stages (CUDA events, median of 3): {stages}", flush=True)
    print(f"profiled call: EighComputation N={N} (model function)", flush=True)
    profile_step(eigh_call)
    return launches


# the in-memory deflated generic Vᵀ of 3c3d at N=512 (9 × 512 × 895,210 f32):
# the streamed N=512 spectrum's peak must stay below it
STREAMED_PEAK_BAR = 9 * N_LARGE * 895_210 * 4
# ‖ΔG‖_F/‖G‖_F of the per-sample-gradient Grams against float64 Grams of
# the same gradients
PRODUCT_BAR = 1e-5
# ‖Δ‖₂/‖ref‖₂ of the f32 matrix-free products (3c3d, N=128, a normal v)
# against float64, a sanity bar at f32's floor (the TF32 flags inside the
# products are the repair's gate): f32 itself is 1.3e-4 (GGN) and 2.8e-4
# (Hessian) off on the H100, TF32 convolutions 2.3e-3 (GGN)
PRODUCT_F64_BAR = 5e-4
# the host-streamed dataset matvec against the on-device one
HOST_STREAM_BAR = 1e-6
# the device Lanczos top Ritz value against λmax of the f32 Gram (the JAX
# example's bar, examples/example_spectral_density.py, is 5e-2)
LANCZOS_BAR = 1e-2
# a unit eigenvector through the projector onto its own basis: the f32
# back-projected vectors are orthonormal to ~1e-5 per pair (max|vᵢᵀvⱼ|)
PROJECTOR_BAR = 1e-4
DATASET = [128, 128, 128, 128, 64]


@contextmanager
def counted(owner, name):
    """Inside the block, count the calls of ``owner.name`` (the yielded
    list gets one entry per call; nothing of the call is kept)."""
    calls = []
    original = getattr(owner, name)

    def wrapper(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, original)


@contextmanager
def timed(owner, name):
    """Inside the block, CUDA events around every call of ``owner.name``;
    the yielded list gets each call's ``(start, end)`` events."""
    import torch

    events = []
    original = getattr(owner, name)

    def wrapper(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = original(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    setattr(owner, name, wrapper)
    try:
        yield events
    finally:
        setattr(owner, name, original)


def peak_of(fn):
    """``(fn(), its peak memory above what was allocated before, in bytes)``."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def rel_err(got, want):
    """‖got − want‖₂/‖want‖₂ over the flattened tensors (or dicts of them),
    in float64."""
    import torch

    if isinstance(want, dict):
        got = torch.cat([got[k].reshape(-1) for k in want])
        want = torch.cat([w.reshape(-1) for w in want.values()])
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def streamed_gram_of(call):
    """``(call(), the Gram its ``chunked.gram_streamed`` built)``."""
    from vivit_tpu_torch import chunked

    with recorded(chunked, "gram_streamed") as grams:
        out = call()
    check(len(grams) == 1, f"{len(grams)} streamed Grams, expected 1")
    gram = grams[0][1]
    return out, gram[0] if isinstance(gram, tuple) else gram


def phase_streamed(jc):
    """The streamed memory mode on the 3c3d model function: the streamed
    Gram against the in-memory one, ``eigvalsh_streamed`` at N=128 and
    N=512 (peak memory, stages), ``eigh_topk_streamed`` and
    ``newton_step_streamed`` at N=128 against float64 of their own Grams.
    Returns the launches per path."""
    import torch

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import chunked, deflate, eig, eigdc
    from vivit_tpu_torch.ggn import ggn_sqrt_vt
    from vivit_tpu_torch.gram import gram_matrix
    from vivit_tpu_torch.optim import utils as optim_utils
    from vivit_tpu_torch.optim.directional_damped_newton import newton_step_from_derivatives
    from vivit_tpu_torch.precision import full_f32

    model_fn, params = generic_model()
    paths = list(params)
    X, y = port_batch(N)
    loss = vtt.CrossEntropyLoss("mean")
    settings = dict(eig_backend="dc", device="cuda", **HEADLINE)
    launches, times = {}, {}

    # the streamed f32 Gram against the in-memory generic one
    def streamed_f32(X_, y_):
        with full_f32():
            return chunked.gram_streamed(model_fn, loss, params, X_, y_, deflate_ce_null=True)

    with counted(chunked, "_vt_single_factor") as slices:
        g_str = streamed_f32(X, y)
    with full_f32():
        g_mem = gram_matrix(ggn_sqrt_vt(model_fn, loss, params, X, y, deflate_ce_null=True))
    rel = rel_err(g_str, g_mem)
    print(f"gram_streamed N={N} (f32, deflated {tuple(g_str.shape)}): {len(slices)} backward "
          f"passes; vs the in-memory generic Gram ‖ΔG‖_F/‖G‖_F {rel:.3e} "
          f"(bar {ENGINE_BAR:.0e})", flush=True)
    check(len(slices) == 54, f"gram_streamed: {len(slices)} backward passes, expected 54")
    check(rel <= ENGINE_BAR, f"gram_streamed: {rel:.2e} off the in-memory Gram")
    times["gram_streamed N=128 (f32)"] = host_ms(lambda: streamed_f32(X, y))
    del g_str, g_mem

    # eigvalsh_streamed N=128: the dc chain path, 2 windows
    label = f"eigvalsh_streamed N={N}"

    def spectrum_small():
        return chunked.eigvalsh_streamed(model_fn, loss, params, X, y, **settings)[0]

    untripped(spectrum_small, label)  # warm-up
    ((evals, batches), gram_d), launches[label] = launches_of(jc, lambda: streamed_gram_of(
        lambda: recording_eigh(lambda: untripped(spectrum_small, label))))
    with full_f32():
        _, info = eigdc.eigvalsh_dc(gram_d, return_info=True)
    print(f"{label}: Jacobi launches {launches[label]}, guard tripped {bool(info['tripped'])} "
          f"(bound {float(info['bound']):.2e}, orth {float(info['orth']):.2e})", flush=True)
    check(launches[label] == 2, f"{label}: expected 2 Jacobi launches, got {launches[label]}")
    check(not bool(info["tripped"]), f"{label}: the eigdc guard tripped")
    check_spectrum(label, evals, gram_d, N)
    win = time_windows(jc, batches, label)
    print(f"{label}, its {launches[label]} window launches: kernel {win[0]:.4f} ms, "
          f"torch.linalg.eigh {win[1]:.4f} ms, bound {win[2]:.6f} ms, plain "
          f"{win[3]:.3f} ms", flush=True)
    times[label] = host_ms(spectrum_small)
    del gram_d

    # eigh_topk_streamed N=128, k=10: the chain path in eigenvector mode
    label = f"eigh_topk_streamed N={N}"

    def eigenpairs():
        return chunked.eigh_topk_streamed(model_fn, loss, params, X, y, TOP_K, **settings)

    untripped(eigenpairs, label)  # warm-up
    (((ev, leaves), batches), gram_d), launches[label] = launches_of(jc, lambda: streamed_gram_of(
        lambda: recording_eigh(lambda: untripped(eigenpairs, label))))
    print(f"{label}: deflated Gram {tuple(gram_d.shape)}, Jacobi launches {launches[label]}, "
          f"top-{TOP_K} {[round(v, 6) for v in ev.tolist()]}", flush=True)
    check(launches[label] == 6, f"{label}: expected 6 Jacobi launches, got {launches[label]}")
    with full_f32():
        vt = ggn_sqrt_vt(model_fn, loss, params, X, y)
        w = deflate.ce_null_complement(deflate.ce_probs(model_fn, X, params))
        ev_d, V_d, info = eigdc.eigh_dc(gram_d, return_info=True)
    check(not bool(info["tripped"]), f"{label}: the eigdc guard tripped")
    check_eigenpairs(label, ev, leaves, paths, vt, w, gram_d, ev_d, V_d)
    del vt, leaves, V_d
    win = time_windows(jc, batches, label)
    print(f"{label}, its {launches[label]} window launches: kernel {win[0]:.4f} ms, "
          f"torch.linalg.eigh {win[1]:.4f} ms, bound {win[2]:.6f} ms, plain "
          f"{win[3]:.3f} ms", flush=True)
    times[label] = host_ms(eigenpairs)

    # newton_step_streamed N=128, k=10, damping 1: against the pipeline
    # in float64 on its own Gram, the vectors through the in-memory V_d
    label = f"newton_step_streamed N={N}"

    def newton():
        return chunked.newton_step_streamed(model_fn, loss, params, X, y, TOP_K, damping=1.0,
                                            **settings)

    untripped(newton, label)  # warm-up
    with recorded(optim_utils, "gammas_lambdas") as derivs:
        (step, batches), launches[label] = launches_of(
            jc, lambda: recording_eigh(lambda: untripped(newton, label)))
    check(len(derivs) == 1, f"{label}: {len(derivs)} γ/λ calls")
    (gram_d, _, _, v_t_g, s), _ = derivs[0]
    with full_f32():
        vt_d = ggn_sqrt_vt(model_fn, loss, params, X, y, deflate_ce_null=True)
        ev64, V64 = torch.linalg.eigh(gram_d.double())
        ev_k, V_k = ev64[-TOP_K:], V64[:, -TOP_K:]
        gammas_o, lambdas_o = optim_utils.gammas_lambdas(gram_d.double(), ev_k, V_k,
                                                         v_t_g.double(), s)
        step_o = newton_step_from_derivatives(vt_d, paths, ev_k.float(), V_k.float(),
                                              gammas_o.float(), lambdas_o.float(), 1.0)
    del vt_d, V64
    ratios = newton_gates("dc", step, derivs[0], (ev64, step_o, gammas_o, lambdas_o), [])
    in_memory = vtt.newton_step_topk(model_fn, loss, X, y, TOP_K, damping=1.0, params=params,
                                     solver="dc", device="cuda", **HEADLINE)
    scale = max(float(t.abs().max()) for t in in_memory)
    dev = max(float((a - b).abs().max()) for a, b in zip(step, in_memory)) / scale
    print(f"{label}: Jacobi launches {launches[label]}; against the float64 pipeline on its "
          "own Gram, max err/tol: " + ", ".join(f"{k} {v:.3f}" for k, (v, _) in ratios.items())
          + f"; vs the in-memory newton_step_topk (function form, dc): max|Δ|/max|step| "
          f"{dev:.3e}", flush=True)
    check(launches[label] == 6, f"{label}: expected 6 Jacobi launches, got {launches[label]}")
    failed = [f"{k} at {v:.2f} of its bar" for k, (v, gated) in ratios.items()
              if gated and v > 1.0]
    check(not failed, f"{label}: " + "; ".join(failed))
    win = time_windows(jc, batches, label)
    print(f"{label}, its {launches[label]} window launches: kernel {win[0]:.4f} ms, "
          f"torch.linalg.eigh {win[1]:.4f} ms, bound {win[2]:.6f} ms, plain "
          f"{win[3]:.3f} ms", flush=True)
    times[label] = host_ms(newton)
    del step, in_memory, step_o, derivs

    # eigvalsh_streamed N=512: the strip path, peak memory, stages
    n = N_LARGE
    X5, y5 = port_batch(n)
    label = f"eigvalsh_streamed N={n}"

    def spectrum_large():
        return chunked.eigvalsh_streamed(model_fn, loss, params, X5, y5, **settings)[0]

    untripped(spectrum_large, label)  # warm-up
    (((evals, gram_d), peak), launches[label]) = launches_of(jc, lambda: peak_of(
        lambda: streamed_gram_of(lambda: untripped(spectrum_large, label))))
    with full_f32():
        _, info = eigdc.eigvalsh_dc(gram_d, return_info=True)
    print(f"{label}: Jacobi launches {launches[label]}, guard tripped {bool(info['tripped'])}, "
          f"peak memory {peak / 1e9:.3f} GB above what the call started with "
          f"(bar: the in-memory deflated Vᵀ, {STREAMED_PEAK_BAR / 1e9:.2f} GB)", flush=True)
    check(launches[label] == 0, f"{label}: expected 0 Jacobi launches, got {launches[label]}")
    check(not bool(info["tripped"]), f"{label}: the eigdc guard tripped")
    check(peak < STREAMED_PEAK_BAR, f"{label}: peak {peak / 1e9:.2f} GB")
    check_spectrum(label, evals, gram_d, n)
    del gram_d
    times[label] = host_ms(spectrum_large)
    with timed(chunked, "_vt_single_factor") as slice_ev, \
            timed(chunked, "_pair_block") as block_ev, timed(eig, "full_eigh") as eig_ev:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spectrum_large()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    stage = {name: sum(a.elapsed_time(b) for a, b in ev) for name, ev in
             (("factor slices", slice_ev), ("pair blocks", block_ev), ("eigensolve", eig_ev))}
    print(f"{label} stages (CUDA events, one call of {wall:.3f} ms host clock): "
          f"{len(slice_ev)} factor slices {stage['factor slices']:.3f} ms, "
          f"{len(block_ev)} pair blocks (bf16 operands) {stage['pair blocks']:.3f} ms, "
          f"eigensolve (dc, strip) {stage['eigensolve']:.3f} ms", flush=True)

    # the in-memory generic f32 Gram at N=512 against the streamed f32 Gram
    g_str, peak_str = peak_of(lambda: streamed_f32(X5, y5))

    def in_memory_f32():
        with full_f32():
            return gram_matrix(ggn_sqrt_vt(model_fn, loss, params, X5, y5,
                                           deflate_ce_null=True))

    torch.cuda.empty_cache()
    g_mem, peak_mem = peak_of(in_memory_f32)
    rel = rel_err(g_str, g_mem)
    print(f"N={n} f32 Grams {tuple(g_mem.shape)}: streamed vs in-memory generic "
          f"‖ΔG‖_F/‖G‖_F {rel:.3e} (bar {ENGINE_BAR:.0e}); peak memory: streamed "
          f"{peak_str / 1e9:.3f} GB, in memory {peak_mem / 1e9:.3f} GB", flush=True)
    check(rel <= ENGINE_BAR, f"N={n}: streamed Gram {rel:.2e} off the in-memory one")
    del g_str, g_mem
    torch.cuda.empty_cache()
    return launches, times


def phase_extensions():
    """``gram_sqrt_ggn`` and ``gram_batch_grad`` on the 3c3d model function
    at N=128; the headline ``eigvalsh_structured`` with
    ``conv_vt_dtype=torch.bfloat16``.  Returns the call times."""
    import torch

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import extensions
    from vivit_tpu_torch.ggn import batch_grad, ggn_sqrt_vt
    from vivit_tpu_torch.gram import gram_matrix, reshape_as_square
    from vivit_tpu_torch.precision import _PRECISIONS, full_f32
    from vivit_tpu_torch.structured import gram_matrix_mixed
    from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt

    model_fn, params = generic_model()
    X, y = port_batch(N)
    loss = vtt.CrossEntropyLoss("mean")
    times = {}

    def sqrt_ggn():
        return extensions.gram_sqrt_ggn(model_fn, loss, X, y, params=params, device="cuda")

    gram4 = sqrt_ggn()
    with full_f32():
        ref = gram_matrix(ggn_sqrt_vt(model_fn, loss, params, X, y))
    rel = rel_err(reshape_as_square(gram4), ref)
    print(f"gram_sqrt_ggn N={N}: {tuple(gram4.shape)}, as a square vs the generic Gram "
          f"‖ΔG‖_F/‖G‖_F {rel:.3e} (bar {ENGINE_BAR:.0e})", flush=True)
    check(rel <= ENGINE_BAR, f"gram_sqrt_ggn: {rel:.2e} off the generic Gram")
    times[f"gram_sqrt_ggn N={N}"] = host_ms(sqrt_ggn)
    del gram4, ref

    grads = batch_grad(model_fn, loss, X, y, params=params)
    flat = torch.cat([g.reshape(N, -1) for g in grads.values()], dim=1).double()
    del grads
    for center in (False, True):
        name = "centered_gram_batch_grad" if center else "gram_batch_grad"
        got = extensions.gram_batch_grad(model_fn, loss, X, y, center=center, params=params,
                                         device="cuda")
        f64 = flat - flat.mean(dim=0) if center else flat
        rel = rel_err(got, f64 @ f64.T)
        print(f"{name} N={N}: vs the float64 Gram of the same per-sample gradients "
              f"‖ΔG‖_F/‖G‖_F {rel:.3e} (bar {PRODUCT_BAR:.0e})", flush=True)
        check(rel <= PRODUCT_BAR, f"{name}: {rel:.2e} off float64")
        times[f"{name} N={N}"] = host_ms(lambda: extensions.gram_batch_grad(
            model_fn, loss, X, y, center=center, params=params, device="cuda"))
    del flat

    # the knob against no knob, under deterministic cuDNN: the default
    # algorithms of the tapped backward need not repeat a call's last bits
    model = port_model()

    def headline_gram(dtype):
        with full_f32():
            vt = tapped_ggn_sqrt_vt(model, loss, X, y, deflate_ce_null=True,
                                    conv_vt_dtype=dtype)
            return gram_matrix_mixed(vt, generic_precision=_PRECISIONS["bf16"])

    repeat = (headline_gram(None) - headline_gram(None)).abs().max().item()
    with deterministic_cudnn():
        without, with_knob = headline_gram(None), headline_gram(torch.bfloat16)
    diff = (with_knob - without).abs().max().item()
    print(f"eigvalsh_structured N={N} headline Gram with conv_vt_dtype=torch.bfloat16: "
          f"max|ΔG| {diff} against the Gram without the knob under deterministic cuDNN "
          f"(two calls without the knob and without deterministic cuDNN: {repeat})",
          flush=True)
    check(torch.equal(with_knob, without), f"conv_vt_dtype: the bf16 Gram moved by {diff}")
    for dtype in (None, torch.bfloat16):
        times[f"eigvalsh_structured N={N} (conv_vt_dtype={dtype})"] = host_ms(
            lambda: vtt.eigvalsh_structured(model, loss, X, y, eig_backend="dc",
                                            conv_vt_dtype=dtype, **HEADLINE))
    return times


def tf32_product(name, model_fn, loss, params, X, y, v):
    """The product as the port computed it before it entered full f32:
    under the process's default TF32 flags (cuDNN convolutions in TF32)."""
    from torch.func import grad, jvp, vjp

    if name == "hessian_vector_product":
        return jvp(grad(lambda p: loss(model_fn(p, X), y)), (params,), (v,))[1]
    f, jv = jvp(lambda p: model_fn(p, X), (params,), (v,))
    _, vjp_fn = vjp(lambda p: model_fn(p, X), params)
    return vjp_fn(loss.hessian_vp(f, y, jv))[0]


def phase_matrix_free():
    """The matrix-free products at N=128 against float64, the dataset
    operators (576 images), the device Lanczos and the Lanczos density.
    Returns the times."""
    import torch

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import hessianfree as hf
    from vivit_tpu_torch.ggn import ggn_vector_product, hessian_vector_product
    from vivit_tpu_torch.utils.tree import num_params

    model_fn, params = generic_model()
    X, y = port_batch(N)
    loss = vtt.CrossEntropyLoss("mean")
    times = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    v = {k: torch.randn(p.shape, generator=gen, device="cuda") for k, p in params.items()}
    p64 = {k: p.double() for k, p in params.items()}
    v64 = {k: t.double() for k, t in v.items()}
    flags = []

    def recording(p, x):  # the TF32 flags each forward of a product runs under
        flags.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return model_fn(p, x)

    for name, product in (("ggn_vector_product", ggn_vector_product),
                          ("hessian_vector_product", hessian_vector_product)):
        flags.clear()
        got = product(recording, loss, params, X, y, v)
        ref = product(model_fn, loss, p64, X.double(), y, v64)
        rel = rel_err(got, ref)
        tf32_off = all(f == (False, False) for f in flags)
        tf32 = rel_err(tf32_product(name, model_fn, loss, params, X, y, v), ref)
        print(f"{name} N={N}: TF32 off in all {len(flags)} forwards {tf32_off}; vs float64 "
              f"‖Δ‖₂/‖ref‖₂ {rel:.3e} (bar {PRODUCT_F64_BAR:.0e}); under the default TF32 "
              f"flags, as before the products entered full f32: {tf32:.3e}", flush=True)
        check(flags and tf32_off, f"{name}: TF32 on inside")
        check(rel <= PRODUCT_F64_BAR, f"{name}: {rel:.2e} off float64")
        times[f"{name} N={N}"] = host_ms(lambda: product(model_fn, loss, params, X, y, v))
    del p64, v64, ref

    rng = np.random.default_rng(0)
    data = [(rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
             rng.integers(0, NUM_CLASSES, size=(b,)).astype(np.int32)) for b in DATASET]
    dim = num_params(params)
    t0 = time.perf_counter()
    op = hf.GGNLinearOperator(model_fn, loss, params, data, check_deterministic=True,
                              device="cuda")
    torch.cuda.synchronize()
    times["GGNLinearOperator construction with its determinism check"] = (
        time.perf_counter() - t0) * 1e3
    dev_op = hf.ggn_operator(model_fn, loss, params, data, device="cuda")
    host_op = hf.ggn_operator(model_fn, loss, params, data, host_stream=True, device="cuda")
    vec = torch.randn(dim, generator=gen, device="cuda")
    rel = rel_err(host_op(vec), dev_op(vec))
    print(f"GGNLinearOperator on {sum(DATASET)} images ({DATASET}): the determinism check "
          f"passed on the card; host_stream vs on-device matvec ‖Δ‖₂/‖ref‖₂ {rel:.3e} "
          f"(bar {HOST_STREAM_BAR:.0e})", flush=True)
    check(rel <= HOST_STREAM_BAR, f"host_stream matvec {rel:.2e} off the on-device one")
    times[f"dataset GGN matvec ({sum(DATASET)} images, on the device)"] = cuda_ms(
        lambda: dev_op(vec), reps=3, warmup=1)
    times[f"dataset GGN matvec ({sum(DATASET)} images, host_stream)"] = cuda_ms(
        lambda: host_op(vec), reps=3, warmup=1)

    # the device Lanczos on the one-batch operator against λmax
    one = hf.ggn_operator(model_fn, loss, params, [(X, y)], device="cuda")
    ritz, _ = hf.fast_lanczos_jax(one, dim, ncv=128, key=0, device="cuda")
    lmax = vtt.eigvalsh_structured(port_model(), loss, X, y, eig_backend="dc",
                                   precision="highest", deflate_ce_null=True)[0][-1]
    dev = abs(float(ritz[-1]) - float(lmax)) / float(lmax)
    print(f"fast_lanczos_jax (device loop, ncv=128) on the N={N} operator: top Ritz value "
          f"{float(ritz[-1]):.6f} vs eigvalsh_structured λmax (f32 Gram) {float(lmax):.6f}, "
          f"relative deviation {dev:.3e} (bar {LANCZOS_BAR:.0e}; the JAX example's 5e-2)",
          flush=True)
    check(dev <= LANCZOS_BAR, f"device Lanczos: top Ritz value {dev:.2e} off λmax")
    # LowRank and Projector from eigh_topk's card tensors: the top pair
    # against the exact matvec (BASELINE's G e = λ e bar), P e = e
    evals, evecs = vtt.eigh_topk(model_fn, loss, X, y, k=TOP_K, params=params,
                                 deflate_ce_null=True, device="cuda")
    A = stacked(evecs).float().T.contiguous()
    top = A[:, -1]
    res = rel_err(torch.as_tensor(hf.LowRank(evals, A, device="cuda") @ top, device="cuda"),
                  one(top))
    proj = rel_err(torch.as_tensor(hf.Projector(A, device="cuda") @ top, device="cuda"), top)
    print(f"LowRank(eigh_topk's top-{TOP_K} pairs, card tensors) @ e_max vs the exact matvec "
          f"‖Δ‖₂/‖ref‖₂ {res:.3e} (bar {RES_RTOL:.0e}); Projector @ e_max vs e_max "
          f"{proj:.3e} (bar {PROJECTOR_BAR:.0e})", flush=True)
    check(res <= RES_RTOL, f"LowRank: the top eigenpair {res:.2e} off the exact matvec")
    check(proj <= PROJECTOR_BAR, f"Projector: e_max moved by {proj:.2e}")
    times["fast_lanczos_jax sweep (ncv=128, one batch)"] = host_ms(
        lambda: hf.fast_lanczos_jax(one, dim, ncv=128, key=0, device="cuda"), reps=1)

    # the Lanczos density of the dataset GGN.  Its boundaries: λmax by ARPACK
    # and 0, the GGN being PSD of rank ≤ 9·576 in 895,210 dimensions.
    # approximate_boundaries' "BE" does not converge here: ARPACK's residual
    # test is relative to the Ritz value, and the bottom ones are ~0
    from scipy.sparse.linalg import eigsh

    with counted(op, "_matvec") as arpack:
        t0 = time.perf_counter()
        (top,) = eigsh(op.as_scipy(), k=1, which="LA", tol=1e-2, return_eigenvectors=False)
        arpack_ms = (time.perf_counter() - t0) * 1e3
    bounds = (0.0, float(top))
    t0 = time.perf_counter()
    grid, density = hf.lanczos_approximate_spectrum(op, ncv=64, num_points=1024,
                                                    boundaries=bounds, seed=0)
    density_ms = (time.perf_counter() - t0) * 1e3
    mass = float(np.trapezoid(density, grid))
    print(f"lanczos_approximate_spectrum (ncv=64) on {sum(DATASET)} images: boundaries "
          f"[0, {bounds[1]:.6f}], λmax by ARPACK in {len(arpack)} matvecs "
          f"({arpack_ms:.1f} ms); density mass {mass:.4f} ({density_ms:.1f} ms)", flush=True)
    check(abs(mass - 1.0) <= 0.05, f"Lanczos density mass {mass:.3f}")
    return times


# the data-parallel Newton step against the single-device
# newton_step_structured: both solve the top-10 of a bf16 Gram, but of
# different V (factor-level against Gram-level CE deflation), as the
# streamed step against the in-memory one (2.357e-04 of max|step| on an H100)
DP_STEP_BAR = 1e-3


def phase_data_parallel(jc):
    """The data-parallel builders (``vivit_tpu_torch.parallel``) in an NCCL
    group of world size 1 made in this process, on 3c3d at N=128 with the
    headline settings.  Returns ``(launches per path, call times)``."""
    import os

    import torch.distributed as dist

    from vivit_tpu_torch.parallel.launch import free_port

    os.environ["MASTER_ADDR"] = "127.0.0.1"
    os.environ["MASTER_PORT"] = str(free_port())
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        return data_parallel_gates(jc)
    finally:
        dist.destroy_process_group()


def data_parallel_gates(jc):
    """Each builder's gates, window batches and call time (phase 13)."""
    from contextlib import nullcontext

    import torch
    import torch.distributed as dist

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import eigdc, structured
    from vivit_tpu_torch import parallel as par
    from vivit_tpu_torch.ggn import batch_grad, ggn_sqrt_vt
    from vivit_tpu_torch.optim.directional_damped_newton import newton_step_from_derivatives
    from vivit_tpu_torch.optim.utils import gammas_lambdas
    from vivit_tpu_torch.parallel import streamed
    from vivit_tpu_torch.precision import full_f32

    model = port_model()
    model_fn, params = generic_model()
    paths = list(params)
    X, y = port_batch(N)
    loss = vtt.CrossEntropyLoss("mean")
    generic = dict(precision="highest", deflate_ce_null=True)  # no gram_precision knob
    launches, times = {}, {}

    def run(label, call, owner=None, name=None):
        """A warm-up, then ``(out, the recorded calls of owner.name, the
        batches batched_eigh received)`` of one call, its launches counted."""
        untripped(call, label)
        with (recorded(owner, name) if owner else nullcontext([])) as calls:
            (out, batches), launches[label] = launches_of(
                jc, lambda: recording_eigh(lambda: untripped(call, label)))
        return out, calls, batches

    def report(label, expect, info=None):
        guard = "" if info is None else (
            f", guard tripped {bool(info['tripped'])} (bound {float(info['bound']):.2e}, "
            f"orth {float(info['orth']):.2e})")
        print(f"{label}: Jacobi launches {launches[label]}{guard}", flush=True)
        check(launches[label] == expect,
              f"{label}: expected {expect} Jacobi launches, got {launches[label]}")
        check(info is None or not bool(info["tripped"]), f"{label}: the eigdc guard tripped")

    def windows(label, batches, timed=True):
        """The kernel on the solve's windows: timed on the paths of PERF.md's
        kernel table, checked alone on the others."""
        win = time_windows(jc, batches, label, timed)
        if timed:
            print(f"{label}, its {launches[label]} window launches: kernel {win[0]:.4f} ms, "
                  f"torch.linalg.eigh {win[1]:.4f} ms, bound {win[2]:.6f} ms, plain "
                  f"{win[3]:.3f} ms", flush=True)

    def timed_call(label, call):
        # the builders' calls ran just before: no extra warm-up
        times[label] = host_ms(call, warmup=False)
        print(f"{label}: {times[label]:.3f} ms median of 3 (host clock, after a warm-up)",
              flush=True)

    def eval_ratio(got, want):
        want = want.double()
        return ((got.double() - want).abs()
                / (ATOL * want.abs().max() + RTOL * want.abs())).max().item()

    # eigvalsh_dp_structured: the headline's builder
    label = f"eigvalsh_dp_structured N={N} (world size 1)"
    fn = par.eigvalsh_dp_structured(model, loss, None, eig_backend="dc", return_eig_info=True,
                                    **HEADLINE)
    (evals, info), grams, batches = run(label, lambda: fn(X, y), par, "_structured_gram_dp")
    gram = grams[0][1]
    report(label, 2, info)
    check_spectrum(label, evals, gram, N)
    (single,) = vtt.eigvalsh_structured(model, loss, X, y, eig_backend="dc", **HEADLINE)
    ratio = eval_ratio(evals, single)
    print(f"{label} vs eigvalsh_structured on the same batch: max err/tol {ratio:.3f}",
          flush=True)
    check(ratio <= 1.0, f"{label}: {ratio:.2f} of the eigenvalue bar off eigvalsh_structured")
    windows(label, batches)
    timed_call(label, lambda: fn(X, y))

    # its collectives, bare (world size 1: copies on the card, no link)
    with recorded(par, "sharded_gram") as calls:
        fn(X, y)
    v = calls[0][0][0]
    send = v.reshape(v.shape[0], 1, -1).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    t_a2a = cuda_ms(lambda: dist.all_to_all_single(recv, send), reps=5)
    g = gram.clone()
    t_ar = cuda_ms(lambda: dist.all_reduce(g), reps=20)
    a2a_gb, ar_gb = send.numel() * 4 / 1e9, g.numel() * 4 / 1e9
    print(f"collectives at world size 1 (NCCL, copies on the card): all_to_all_single of the "
          f"conv/bias V rows {tuple(v.shape)} f32 ({a2a_gb:.3f} GB) {t_a2a:.3f} ms "
          f"({2 * a2a_gb / t_a2a * 1e3:.1f} GB/s read + write); all_reduce of the Gram "
          f"{tuple(g.shape)} ({ar_gb * 1e3:.3f} MB) {t_ar:.4f} ms (CUDA events, median)",
          flush=True)
    times["all_to_all_single (world size 1)"], times["all_reduce (world size 1)"] = t_a2a, t_ar
    del calls, v, send, recv, g, gram, grams

    # eigvalsh_dp: the generic V-transform of the model function
    label = f"eigvalsh_dp N={N} (world size 1)"
    fn = par.eigvalsh_dp(model_fn, loss, None, eig_backend="dc", return_eig_info=True,
                         **generic)
    (evals, info), grams, batches = run(label, lambda: fn(params, X, y), par, "sharded_gram")
    report(label, 2, info)
    check_spectrum(label, evals, grams[0][1], N)
    del grams
    windows(label, batches, timed=False)
    timed_call(label, lambda: fn(params, X, y))

    # eigh_dp: the k_top path against float64, the criterion path
    label = f"eigh_dp N={N}, k_top={TOP_K} (world size 1)"
    fn = par.eigh_dp(model_fn, loss, None, TOP_K, solver="dc", return_eig_info=True,
                     **generic)
    (ev, vecs, info), grams, batches = run(label, lambda: fn(params, X, y), par,
                                           "sharded_gram")
    report(label, 6, info)
    gram_d = grams[0][1]
    with full_f32():
        vt = ggn_sqrt_vt(model_fn, loss, params, X, y, deflate_ce_null=True)
        ev_d, V_d = eigdc.eigh_dc(gram_d)
    check_eigenpairs(label, ev, [vecs[p] for p in paths], paths, vt, None, gram_d, ev_d, V_d)
    del vt, vecs, grams, gram_d, V_d
    windows(label, batches, timed=False)
    timed_call(label, lambda: fn(params, X, y))
    crit = par.eigh_dp(model_fn, loss, None, criterion=vtt.keep_top_k(TOP_K), solver="dc",
                       **generic)
    ev_c, _ = untripped(lambda: crit(params, X, y), label)
    ratio = eval_ratio(ev_c, ev)
    print(f"eigh_dp N={N}, criterion keep_top_k({TOP_K}) (world size 1): top-{TOP_K} vs the "
          f"k_top path max err/tol {ratio:.3f}", flush=True)
    check(ratio <= 1.0, f"eigh_dp criterion path: {ratio:.2f} of the bar off k_top")

    # directional_derivatives_dp against directional_derivatives_topk
    label = f"directional_derivatives_dp N={N}, k_top={TOP_K} (world size 1)"
    fn = par.directional_derivatives_dp(model_fn, loss, None, TOP_K, solver="dc",
                                        return_eig_info=True, **generic)
    (ev, gammas, lambdas, info), _, batches = run(label, lambda: fn(params, X, y))
    report(label, 6, info)
    ev_s, gammas_s, lambdas_s = vtt.directional_derivatives_topk(
        model_fn, loss, X, y, TOP_K, params=params, solver="dc", deflate_ce_null=True,
        device=X.device)
    sign = (gammas.double() * gammas_s.double()).sum(dim=0).sign()
    ratios = {"top-10 eigenvalues": eval_ratio(ev, ev_s)}
    for name, got, want, atol in (("γ", gammas.double() * sign, gammas_s, GAMMA_ATOL),
                                  ("λ", lambdas, lambdas_s, LAMBDA_ATOL)):
        want = want.double()
        tol = atol * max(float(want.abs().max()), 1.0) + NEWTON_RTOL * want.abs()
        ratios[name] = ((got.double() - want).abs() / tol).max().item()
    print(f"{label} vs directional_derivatives_topk (single device, f32 Gram, dc), max "
          "err/tol: " + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()), flush=True)
    bad = [f"{k} at {v:.2f} of its bar" for k, v in ratios.items() if v > 1.0]
    check(not bad, f"{label}: " + "; ".join(bad))
    windows(label, batches, timed=False)
    timed_call(label, lambda: fn(params, X, y))

    # newton_step_dp_structured against float64 on its own Gram
    label = f"newton_step_dp_structured N={N}, k_top={TOP_K} (dc, world size 1)"
    fn = par.newton_step_dp_structured(model, loss, None, TOP_K, 1.0, solver="dc", **HEADLINE)
    mpaths = [name for name, _ in model.named_parameters()]
    with recorded(structured, "structured_ggn_sqrt_vt") as vts:
        (ev, step), grams, batches = run(label, lambda: fn(X, y), par, "_structured_gram_dp")
    report(label, 6)
    gram, vt = grams[0][1], vts[-1][1]
    with full_f32():
        ev64, Q64 = torch.linalg.eigh(gram.double())
        ev_k, V_k = ev64[-TOP_K:], Q64[:, -TOP_K:]
        grads = batch_grad(model, loss, X, y)
        v_t_g = structured.vt_mat_prod_mixed(vt, [grads[p] * N for p in mpaths], mpaths)
        gammas_o, lambdas_o = gammas_lambdas(gram.double(), ev_k, V_k, v_t_g.double(), N)
        step_o = newton_step_from_derivatives(vt, mpaths, ev_k.float(), V_k.float(),
                                              gammas_o.float(), lambdas_o.float(), 1.0)
    scale = max(max(float(o.abs().max()) for o in step_o), 1.0)
    ratios = {"top-10 eigenvalues": eval_ratio(ev, ev_k), "step": max(
        ((s.double() - o.double()).abs()
         / (NEWTON_ATOL * scale + NEWTON_RTOL * o.double().abs())).max().item()
        for s, o in zip(step, step_o))}
    single = vtt.newton_step_structured(model, loss, X, y, TOP_K, damping=1.0, solver="dc",
                                        **HEADLINE)
    dev = (max(float((a - b).abs().max()) for a, b in zip(step, single))
           / max(float(t.abs().max()) for t in single))
    print(f"{label}: against the float64 pipeline on its own Gram, max err/tol: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items())
          + f"; vs newton_step_structured (dc) on the same batch: max|Δ|/max|step| "
          f"{dev:.3e} (bar {DP_STEP_BAR:.0e})", flush=True)
    bad = [f"{k} at {v:.2f} of its bar" for k, v in ratios.items() if v > 1.0]
    check(not bad, f"{label}: " + "; ".join(bad))
    check(dev <= DP_STEP_BAR, f"{label}: {dev:.2e} off newton_step_structured")
    del vts, vt, grams, gram, grads, v_t_g, step_o, single
    windows(label, batches)
    timed_call(label, lambda: fn(X, y))

    # eigvalsh_streamed_dp: the stream's backward passes; its f32 Gram
    # against the in-memory sharded_gram
    label = f"eigvalsh_streamed_dp N={N} (world size 1)"
    fn = par.eigvalsh_streamed_dp(model_fn, loss, None, eig_backend="dc",
                                  return_eig_info=True, **HEADLINE)
    untripped(lambda: fn(params, X, y), label)  # warm-up
    with counted(streamed, "_vt_slice_flat") as slices, \
            recorded(streamed, "gram_streamed_shard") as grams:
        ((evals, info), batches), launches[label] = launches_of(jc, lambda: recording_eigh(
            lambda: untripped(lambda: fn(params, X, y), label)))
    passes = len(slices)
    print(f"{label}: {passes} backward passes", flush=True)
    check(passes == 45, f"{label}: {passes} backward passes, expected 45")
    report(label, 2, info)
    check_spectrum(label, evals, grams[0][1], N)
    del grams
    with full_f32():
        g_str = par.gram_streamed_shard(model_fn, loss, params, X, y, paths=paths,
                                        deflate_ce_null=True)
        vt = ggn_sqrt_vt(model_fn, loss, params, X, y, deflate_ce_null=True)
        g_mem = par.sharded_gram(par._flatten_vt(vt, paths))
    del vt
    cf = g_str.shape[0] // N
    perm = torch.arange(cf * N, device=X.device).reshape(cf, 1, N).transpose(0, 1).reshape(-1)
    rel = rel_err(g_str[perm][:, perm], g_mem)
    print(f"gram_streamed_shard N={N} (f32, deflated {tuple(g_str.shape)}) vs the in-memory "
          f"sharded_gram, (cf, rank, n) → (rank, cf, n): ‖ΔG‖_F/‖G‖_F {rel:.3e} "
          f"(bar {ENGINE_BAR:.0e})", flush=True)
    check(rel <= ENGINE_BAR, f"gram_streamed_shard: {rel:.2e} off the in-memory Gram")
    del g_str, g_mem
    windows(label, batches)
    timed_call(label, lambda: fn(params, X, y))

    # train_step_dp: three steps lower the loss on the batch
    label = f"train_step_dp N={N}, k_top={TOP_K}, 3 steps (dc, world size 1)"
    step = par.train_step_dp(model_fn, loss, None, TOP_K, damping=1.0, lr=1.0, solver="dc",
                             **generic)

    def batch_loss(p):
        with torch.no_grad():
            return float(loss(model_fn(p, X), y))

    def three_steps():
        p, out = params, [batch_loss(params)]
        for _ in range(3):
            p, _ = untripped(lambda: step(p, X, y), label)
            out.append(batch_loss(p))
        return out

    losses, launches[label] = launches_of(jc, three_steps)
    print(f"{label}: loss on the batch {[round(v, 6) for v in losses]}, Jacobi launches "
          f"{launches[label]}", flush=True)
    check(losses[-1] < losses[0], f"{label}: the loss did not fall: {losses}")
    check(launches[label] == 18, f"{label}: {launches[label]} Jacobi launches, expected 18")
    timed_call(f"train_step_dp N={N}, k_top={TOP_K}, one step (dc, world size 1)",
               lambda: step(params, X, y))
    return launches, times


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from vivit_tpu_torch.kernels import jacobi_cuda as jc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _, build_s, log = jc.build()
    print(f"Jacobi kernel build (nvcc, sm_90a): {build_s:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}", flush=True)

    try:
        max_err, timing = phase_kernel(jc)
        phase_shape_sweep(jc)
        launches = phase_main_path(jc)
        model = port_model()
        small, evecs_launches, (gram_d, _, V_d), batches = phase_eigenpairs(jc, model, N, 6)
        win = time_windows(jc, batches, f"eigh_topk N={N}")
        print(f"eigh_topk N={N}, the {evecs_launches} window launches of one solve: kernel "
              f"{win[0]:.4f} ms, torch.linalg.eigh {win[1]:.4f} ms, bound {win[2]:.6f} ms, "
              f"plain {win[3]:.3f} ms", flush=True)
        refine_launches = phase_refine(jc, gram_d, V_d)
        spectrum_launches, spectrum = phase_spectrum_large(jc, model)
        large, large_launches, _, _ = phase_eigenpairs(jc, model, N_LARGE, 0)
        phase_times(jc, model, small, large, spectrum)
        newton_launches = phase_newton(jc, model)
        del model
        generic_launches = phase_generic(jc)
        streamed_launches, times = phase_streamed(jc)
        times.update(phase_extensions())
        times.update(phase_matrix_free())
        dp_launches, dp_times = phase_data_parallel(jc)
        times.update(dp_times)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        return 1
    print(card, flush=True)  # again beside the times, inside a tail of the output
    for name, ms in times.items():
        print(f"time: {name}: {ms:.3f} ms", flush=True)

    print("Jacobi launches per path: " + json.dumps({
        f"eigvalsh_structured N={N}": launches,
        f"eigh_topk N={N}": evecs_launches,
        f"refine_eigh N={N}": refine_launches,
        f"eigvalsh_structured N={N_LARGE}": spectrum_launches,
        f"eigh_topk N={N_LARGE}": large_launches,
        f"newton_step_structured N={N} (lobpcg)": newton_launches["lobpcg"],
        f"newton_step_structured N={N} (dc)": newton_launches["dc"],
        **generic_launches, **streamed_launches, **dp_launches}), flush=True)

    t = [timing[s] for s in HEADLINE_SHAPES]
    kernels = [{
        "name": "jacobi_eigh",
        "route": "cuda",
        "source": "vivit_tpu_torch/csrc/jacobi.cu",
        "replaces": "vivit_tpu/kernels/jacobi_pallas.py:178",
        "launches": launches,
        "max_abs_err": max_err,
        # the most sweeps a matrix of the two window batches ran
        "sweeps": max(x[5] for x in t),
        # times: the sum over the two window launches of one n=1152 solve;
        # the bound counts the sweeps each matrix ran
        "ms": sum(x[0] for x in t),
        "plain_ms": sum(x[1] for x in t),
        "bound_ms": sum(x[3] for x in t),
        "bound_by": t[0][4],
        "library_ms": sum(x[2] for x in t),
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
