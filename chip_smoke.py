#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vivit_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it runs:

1. **Card**: ``nvidia-smi`` name and power limit, then the builds of the
   window kernel ``vivit_tpu_torch/csrc/jacobi.cu``, the leaf kernel
   ``vivit_tpu_torch/csrc/jacobi_leaf.cu`` and the token expansion
   ``vivit_tpu_torch/csrc/token_expand.cu`` (``nvcc``, sm_90a, one process
   each, started together).
2. **Kernel against its plain version** on the card at the window shapes of
   the eigensolver, plus two degenerate inputs; the sweeps the kernel ran
   (its exact early exit) against those of the plain version under the same
   rule; times of the kernel, its plain version and ``torch.linalg.eigh`` on
   the same batch (CUDA events around 10 calls back to back and around one
   call, median), beside the bound on the sweeps run and on all 12.
   Then a **shape sweep** over the kernel's envelope, the kernel against
   ``torch.linalg.eigh`` at ``b in {1, 8, 37, 64, 73, 132, 146, 292, 438}``
   x ``m in {32, 48, 64}`` (up to four waves of one CTA per SM at m=64),
   each shape first held to its plain version and float64 (CUDA events,
   median and spread of 5).  Then the **leaf kernel's sweep**
   (:data:`LEAF_SWEEP`, b in {1, 16, 132} x m in {40, 95, 96, 128, 150,
   160}): each shape bit-equal to its plain version with equal sweeps,
   within float64's bars, timed beside the plain version,
   ``torch.linalg.eigh`` and its bound (:func:`leaf_row`).
3. **Main path**: ``eigvalsh_structured`` on full-width CIFAR-10 3c3d at
   N=128 with the headline settings (bf16 Gram, CE deflation, dc
   eigensolver).  Weights: ``cnn3c3d_flax_params(seed=0)`` (numpy) through
   ``params_from_flax``; data: numpy ``default_rng(0)``.  Checks the kernel
   launch count, the guard, the structural zeros, and both the deflated
   Gram's dc eigenvalues and the entry's returned spectrum against float64;
   runs the two window batches of that solve again through the kernel and
   its plain version (equal sweeps) and times them beside
   ``torch.linalg.eigh``; the same for its leaf and edge batches through
   the leaf kernel (2 launches, :func:`time_leaves`); times the step and
   its three stages.  Phases 4-6 read their leaf batches the same way
   (N=128 eigenpairs: 1 launch; N=512: the strip path's edge blocks).
4. **N=128 eigenpairs**: ``eigh_topk(k=10, solver="dc")`` with the same
   settings (the bf16 Gram, deflated at the Gram level to 1152², the dc
   solver's chain path in eigenvector mode): 6 Jacobi launches, the guard,
   the top-10 eigenvalues, Gram-space residuals, the full 1152 basis and the
   back-projected parameter-space vectors against float64; the six window
   batches through the kernel and its plain version, timed beside
   ``torch.linalg.eigh``; then ``refine_eigh`` on the same Gram, warm-started
   from the dc basis (2 launches).
5. **N=512 spectrum**: ``eigvalsh_structured`` with the headline settings at
   N=512 (4608², the strip path): 4 Jacobi launches (its w=64 windows
   ``[73,64,64]`` and ``[72,64,64]``, twice), the guard, 0/4608 float64
   violations, 512 structural zeros; the windows through kernel and plain
   version, timed.
6. **N=512 eigenpairs**: ``eigh_topk`` at N=512 (the strip path in
   eigenvector mode), the checks of phase 4 with 6 launches, its windows
   timed.
7. **Times**: each new entry's call (median of 3 after a warm-up, host
   clock around a synchronised call; the N=512 eigenpairs one call) and its
   stages on CUDA events; one profiled N=512 eigenpair call.
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
    path, 4 launches, its windows timed, 0/5120 violations, peak memory
    below the in-memory
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
14. **eigh_dc's routes** (:data:`ROUTES`) on the deflated Grams of phases
    4 and 6: ``ladder=False`` (the recursive chain; 1152², both modes),
    ``deskew_terms=4`` (the ladder's 4-term root; 1152²), ``strip=1024``
    (the strip below 1536; 1152²), ``strip=0`` (the deep-map root, 4-term;
    4608²) and the forced trip of ``tests/test_guard_info.py`` (1152², both
    modes): each route's Jacobi launches (2·Σ ``wj_iters``), its guarded
    result against float64, its raw (``guard=None``) violations and the trip
    flag (the forced trip must trip), its time beside the default route's
    (CUDA events, median of 5 calls each, in turns), its window batches
    through the kernel and its plain version (bit-equal, timed), and the
    kernel at sweeps 1, 4 and 12 on its first window batch of each shape,
    bit-equal to its plain version with no matrix past the cap.
15. **Captured execution** (:func:`phase_graphs`): every chain-path
    ``eigh_dc`` call on the card replays CUDA graphs captured on its first
    call per key (``vivit_tpu_torch.utils.graphs``), so every gate above
    reads replays, their Jacobi launches counted by the replay.  For the
    headline's and ``eigh_topk``'s N=128 solves: the capture (time, graphs,
    vendor steps and their shapes: none and one graph in eigenvalues mode,
    only blocks above m=160 in eigenvector mode; the leaf kernel's 2 and 1
    launches, the trace's count equal), the replay bit-equal to the eager body
    with the same key, launches outside graphs beside the vendor steps' own
    (at most :data:`OUTSIDE_BAR` more) and the eager body's, the Jacobi
    kernel's executions in the trace equal to the counter, busy shares; the
    forced trip under replay in both modes (it trips, warns, and returns
    the vendor's result); the headline, ``eigh_topk``, the dc Newton step
    and both classes timed replay against eager body in turns, bit-equal
    under deterministic cuDNN; the cache's memory before and after
    ``clear()``; and the tally of every chain-path solve of the phases above,
    each replay held against the eager body by :func:`recording_eigh`.
    Phases 3-14 read the entry points through their graphs too (phase 16);
    here, and for the tally of :func:`recording_eigh`, their bodies run
    eagerly around the replayed solves (:func:`eager_entries`).
16. **Entry graphs** (:func:`phase_entry_graphs`): every N=128 entry point
    (``eigvalsh_structured`` with the headline settings, ``eigvalsh`` on the
    model function, ``eigh_topk``, ``directional_derivatives_topk``,
    ``newton_step_structured`` with ``"dc"`` and ``"lobpcg"``, and the four
    computation classes on the model function of phase 9 and on the module)
    replays CUDA graphs of its whole call, captured on its first call per
    key; under deterministic cuDNN: the capture (time, programs, graphs,
    eager steps, pool bytes), the replay bit-equal to the eager body, equal
    to a fresh eager call after an in-place SGD step and on a new batch
    (same key), and after a replaced parameter tensor (a model function's
    params are copied in: the same key; a module's are read in place: a
    new key, the stale one dropped), launches outside graphs beyond the
    eager steps' own and a class's eager rest after its program (at most
    :data:`OUTSIDE_BAR`), no eager step in an eigenvalues-mode call and
    only vendor blocks above m=160 in the others, both kernels' executions
    in the trace equal to their counters (:data:`EIGVALS`,
    :data:`EIGPAIRS`), busy shares, the replay against solve-only graphs (the
    body eager, its chain solve replayed) and against no graphs in turns,
    and a guard trip under replay, forced by a zero threshold (one warning,
    the eager call's result).  Each key's pool is printed and released
    (``graphs.clear()``), here and before the N=512 phases; every entry
    replay of phases 3-15 (:func:`recording_eigh`, which runs the eager
    body once more for what the phases record) is held against its eager
    body: bit-equal, or within :data:`ENTRY_BAR` of it.
17. **Three-pass products** (:func:`phase_three_pass`): the kernel of
    ``precision.matmul``'s ``"high"`` (``csrc/three_pass.cu``: three TF32
    passes in one launch) on the strip path, one ``eigvalsh_dc`` of the
    deflated N=512 Gram with the counters set to 0 just before it (its
    launches equal to the engaged products); against the f32 product, its
    plain version, the
    cuBLAS passes it replaced (:func:`cublas_three_pass`, the ``library_ms``
    yardstick), bf16_3x (the JAX package's ``"high"``: three bf16 products
    of the operands' bf16 parts, f32 sums) and float64 at the strip basis's
    shapes (:data:`THREE_PASS_SHAPES`: 4608³ with distinct operands and as
    a squaring, 4608×4608×2400 and its ``Yᵀ Y`` on a transposed view,
    2448³ as a squaring, a ``[2,1250,1250]`` batch): one launch, its error
    at most twice the f32 product's, and,
    where the product engages (every side at least
    ``precision.THREE_PASS_MIN``), its time below the cuBLAS passes' and
    the f32 product's (CUDA events, median of 10), each beside its bound;
    the sweep of squares and ``[2, n, n]`` batches
    (:data:`THREE_PASS_SWEEP`), the kernel against the f32 product, each
    crossover named; and the N=128 headline and ``eigh_topk`` calls, which
    reach no ``"high"`` product (``THREE_PASS``, ``THREE_PASS_DECLINED``
    and the kernel's ``LAUNCHES`` unchanged).
18. **Token expansion** (:func:`phase_token_expand`): the columns of
    ViT-S/16's token blocks at N=128 (:data:`TOKEN_LAYERS`, ``CF = 9``,
    ``T = 197``, random factors), one chunk of each layer as
    ``TokenFactor.gram`` cuts it: first the f32 ``torch.bmm`` of
    ``TokenFactor.expand`` (the route before the kernel, TF32 off) timed,
    then the kernel (``csrc/token_expand.cu``: its first call, its time,
    its bound), its plain version's time, the kernel's and the ``bmm``'s
    errors against float64 (the kernel's at most twice the ``bmm``'s),
    the share of their bf16 roundings that differ (at most 0.1%;
    neighbours in bf16 but for elements below 2^8 times the ``bmm``'s own
    largest error), the kernel against its plain version; each layer's
    time a query (its chunks times 12 blocks) for both routes; one bf16
    ``TokenFactor.gram`` per layer under ``torch.profiler``, behind
    :data:`TOKEN_LEAD` spin kernels: the kernel's executions in the trace
    equal to ``LAUNCHES`` and to the chunks, one a chunk, the Gram
    bit-equal to an unprofiled one.  The same checks (:func:`token_chunk`)
    at the LM cell's chunks (:data:`TOKEN_LM_LAYERS`: Moonlight-16B-A3B, 16
    columns over 2,048 positions, where ``z``'s rows leave shared memory
    and each chunk takes one launch a range of :data:`TOKEN_ROWS`
    positions, counted), then at an expert's block over per-sample segments
    padded with zero rows, from the routing a recorded forward of the
    network's first two layers gives (:func:`lm_routed_samples`), also
    held to the ragged segments' float64 block; each shape's time a query
    for both routes.  Last, a small ViT's
    ``eigvalsh_structured`` captured and replayed (:func:`token_capture`):
    the kernel inside the graph, its launches counted by each replay, the
    replay equal to the eager body.
19. The call times of the new entries, the launches of each path (the
    leaf kernel's too), a JSON line of the kernels (the leaf kernel's rows
    by path, :data:`LEAF_ROWS`; the token expansion's by layer), the
    command time, then ``{"ok": true, "device": ...}`` last.

Any failed check exits non-zero.  Without a CUDA device it exits 2 and
prints no result.
"""

import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np

N = 128
NUM_CLASSES = 10
# the three-pass product's shapes on the strip path at N=512 (label, a, b;
# b None: a squaring, a None: Yᵀ Y, a the transposed view of b): the root's
# squarings, a bulk child's panel and its Yᵀ Y, the zoom's squarings, a tree
# level's batch
THREE_PASS_SHAPES = [("4608^3", (4608, 4608), (4608, 4608)),
                     ("4608^3 squaring", (4608, 4608), None),
                     ("4608x4608x2400", (4608, 4608), (4608, 2400)),
                     ("Y^T Y 2400x4608x2400", None, (4608, 2400)),
                     ("2448^3 squaring", (2448, 2448), None),
                     ("[2,1250,1250]", (2, 1250, 1250), (2, 1250, 1250))]
# the sizes n of the crossover sweep, of squares and of [2, n, n] batches
THREE_PASS_SWEEP = (512, 768, 1024, 1280, 1536, 1792, 2048, 2448, 3072)
# the kernels' sources under vivit_tpu_torch/csrc/, built at the start
KERNEL_SOURCES = ("jacobi", "jacobi_leaf", "token_expand", "three_pass")
KERNEL_SHAPES = [(37, 32), (36, 32), (13, 32), (16, 48), (32, 64)]
HEADLINE_SHAPES = [(37, 32), (36, 32)]  # the window solves of one n=1152 solve
SWEEP_SHAPES = [(b, m) for m in (32, 48, 64)
                for b in (1, 8, 37, 64, 73, 132, 146, 292, 438)]
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
# ViT-S/16's token-shaped Linear layers (name, in, out), each in its 12
# blocks, at the benchmark's ViT cell: N=128, CF' = 9 deflated columns a
# sample, T = 197 positions
TOKEN_LAYERS = [("qkv", 384, 1152), ("proj", 384, 384), ("fc1", 384, 1536), ("fc2", 1536, 384)]
TOKEN_CF, TOKEN_T, TOKEN_DEPTH = 9, 197, 12
# Moonlight-16B-A3B's token blocks at the benchmark's LM cell (16 sequences
# of 2,048 tokens, one Monte-Carlo draw: 16 columns): (name, in, out, blocks
# of that shape a query in the dense layer and the four MoE layers), the
# flattened batch's, then the held experts' (8 a MoE layer) over per-sample
# segments of the rows routed to them
TOKEN_LM_LAYERS = [("q_proj", 2048, 3072, 5), ("kv_a_proj_with_mqa", 2048, 576, 5),
                   ("kv_b_proj", 512, 4096, 5), ("o_proj", 2048, 2048, 5),
                   ("dense gate_proj/up_proj", 2048, 11264, 2),
                   ("dense down_proj", 11264, 2048, 1),
                   ("shared gate_proj/up_proj", 2048, 2816, 8),
                   ("shared down_proj", 2816, 2048, 4), ("gate (router)", 2048, 64, 4),
                   ("lm_head", 2048, 20480, 1)]
TOKEN_LM_ROUTED = [("gate_proj/up_proj", 2048, 1408, 64), ("down_proj", 1408, 2048, 32)]
TOKEN_LM_S, TOKEN_LM_T, TOKEN_LM_CF = 16, 2048, 1
# the positions one launch of the token expansion takes at each block width
# (``csrc/token_expand.cu``: ``z``'s rows in shared memory); longer
# contractions run as several launches, each adding into the chunk
TOKEN_ROWS = {192: 240, 128: 296}
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense (NVIDIA data sheet)
# the least share of the kernel's bf16 roundings equal to the f32 bmm's
TOKEN_BF16_EQUAL = 0.999
# spin kernels ahead of phase 18's profiled Grams: late in a long process the
# profiler drops the device records of a profile's first launches, whatever
# they are (1 to 23 of them seen; PERF.md §7), and the lead-in takes the loss
TOKEN_LEAD = 64
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


def cuda_times(fn, reps, warmup=2, calls=1):
    """Times of one call of ``fn`` in ms: CUDA events around ``calls``
    back-to-back calls, over ``calls``, for each of ``reps`` such runs.  With
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
    return times


def cuda_once(fn):
    """``(fn(), its time in ms)``: CUDA events around one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps, warmup=2, calls=1):
    """The median of :func:`cuda_times`."""
    return float(np.median(cuda_times(fn, reps, warmup, calls)))


def spread(times):
    """``"median ms [min-max]"`` of a list of times."""
    return f"{np.median(times):.4f} ms [{min(times):.4f}-{max(times):.4f}]"


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
    """The kernel against ``torch.linalg.eigh`` over ``SWEEP_SHAPES``, each
    shape first held to the plain version and to float64: the data behind
    ``jacobi_supported``."""
    import torch

    for b, m in SWEEP_SHAPES:
        A = torch.tensor(random_sym(b, m, seed=b * 1000 + m), device="cuda")
        label = f"shape sweep [{b},{m},{m}]"
        ev, V, sw = jc.batched_eigh_jacobi_cuda(A, return_sweeps=True)
        ev_p, V_p, sw_p = jc.batched_eigh_jacobi_plain(A, exit_early=True,
                                                       return_sweeps=True)
        torch.cuda.synchronize()
        ref, err64 = check_eigh(A, ev, V, label)
        gap = (ev - ev_p).abs().amax(dim=-1)
        check(bool((gap <= 1e-5 * ref.abs().amax(dim=-1)).all()),
              f"{label}: kernel and plain differ by {gap.max().item():.2e}")
        check(abs(int(sw.max()) - int(sw_p.max())) <= 1,
              f"{label}: kernel ran {int(sw.max())} sweeps, plain {int(sw_p.max())}")
        equal = torch.equal(ev, ev_p) and torch.equal(V, V_p) and torch.equal(sw, sw_p)
        t_k = cuda_times(lambda: jc.batched_eigh_jacobi_cuda(A), reps=5, warmup=1)
        t_l = cuda_times(lambda: torch.linalg.eigh(A), reps=5, warmup=1)
        print(f"{label}: kernel {spread(t_k)}, torch.linalg.eigh {spread(t_l)} "
              f"(CUDA events, median [min-max] of 5), kernel/eigh "
              f"{np.median(t_k) / np.median(t_l):.3f}; sweeps run "
              f"{int(sw.min())}-{int(sw.max())} (plain {int(sw_p.min())}-{int(sw_p.max())}), "
              f"max|kernel-plain| {gap.max().item():.3e}, bit-equal {equal}, "
              f"max|kernel-f64| {err64:.3e}", flush=True)


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
    ((evals,), (info,)), (launches, leaf_launches) = counts_of(step)
    print(f"main path: 3c3d ({n_params} parameters) N={N}, "
          f"{evals.numel()} eigenvalues, Jacobi launches {launches}, leaf-kernel "
          f"launches {leaf_launches}, guard tripped {bool(info['tripped'])} (bound "
          f"{float(info['bound']):.2e}, orth {float(info['orth']):.2e})", flush=True)
    check(launches == 2, f"expected 2 Jacobi launches per solve, got {launches}")
    check(leaf_launches == 2, f"expected 2 leaf-kernel launches per solve (the leaves "
          f"and the bottom block), got {leaf_launches}")
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
        ev_dc, batches = recording_eigh(lambda: eigdc.eigvalsh_dc(gram))
    windows = [A for A in batches if jacobi_supported(A.shape, A.dtype)]
    ref = torch.linalg.eigvalsh(gram.double())
    err = (ev_dc.double() - ref).abs()
    tol = ATOL * ref.abs().max() + RTOL * ref.abs()
    ratio = (err / tol).max().item()
    print(f"deflated Gram {tuple(gram.shape)}: dc vs float64 max err/tol {ratio:.3f}, "
          f"{int((err > tol).sum())} violations", flush=True)
    check(ratio <= 1.0, f"dc eigenvalues off float64 (max err/tol {ratio:.2f})")
    check(len(windows) == 2, f"{len(windows)} window batches, expected 2")
    time_leaves(batches, f"eigvalsh_structured N={N}", leaf_launches)
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
    shown = ranked[:top] + [e for e in ranked[top:]
                            if "jacobi_kernel" in e.key or "leaf_eigh_kernel" in e.key]
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


def port_batch(n, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, size=(n,)).astype(np.int32)
    return torch.tensor(X, device="cuda"), torch.tensor(y, device="cuda")


def untripped(fn, label, keep=False):
    """``fn()``, failing if an eigdc guard tripped inside it (the guard's
    warning is its only trace in an entry point's result).  With ``keep``
    each tripped Gram is kept and solved again (:func:`replay_trips`)
    before the check fails."""
    kept = []
    with warnings.catch_warnings(record=True) as caught, keeping_trips(kept, keep):
        warnings.simplefilter("always")
        out = fn()
    trips = [str(w.message) for w in caught if "guard tripped" in str(w.message)]
    if kept:
        replay_trips(kept, label)
    check(not trips, f"{label}: {trips}")
    return out


# the run's outputs too large for its log (a folder git ignores)
OUT_DIR = "chiprun_out"


@contextmanager
def keeping_trips(kept, on=True):
    """Inside the block (if ``on``), every ``eigh_dc`` call that trips its
    guard outside a captured body appends ``(H, its keywords)`` to
    ``kept``."""
    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch.utils import graphs

    solve = eigdc.eigh_dc

    def read(H, **kw):
        out = solve(H, **{**kw, "return_info": True})
        if not graphs.deferring() and bool(out[2]["tripped"]):
            kept.append((H.detach().clone(), {k: v for k, v in kw.items() if k != "return_info"}))
        return out if kw.get("return_info") else out[:2]

    if on:
        eigdc.eigh_dc = read
    try:
        yield
    finally:
        eigdc.eigh_dc = solve


def replay_trips(kept, label):
    """Each tripped Gram of ``kept`` saved under :data:`OUT_DIR`, then
    solved again with its keywords, uncounted: under the port's rule with
    the leaf kernel's cap of 12 sweeps and of 30, and under the parent's
    rule (the leaf range on the vendor); each solve's guard reading is
    printed, so that a trip shows whether it follows the leaf kernel or
    the Gram."""
    import os

    import torch

    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch.kernels import jacobi
    from vivit_tpu_torch.kernels import jacobi_leaf_cuda as jl
    from vivit_tpu_torch.utils import graphs

    rule, leaf = jacobi.route, jacobi.batched_eigh_leaf

    def parent(shape, dtype, device, eager=False):
        way = rule(shape, dtype, device, eager)
        return "vendor" if way == "leaf" else way

    setups = {"leaf kernel, 12 sweeps": (rule, leaf),
              "leaf kernel, 30 sweeps": (rule, lambda A: jl.batched_eigh_leaf_cuda(A, sweeps=30)),
              "the parent's rule": (parent, leaf)}
    os.makedirs(OUT_DIR, exist_ok=True)
    for i, (H, kw) in enumerate(kept):
        path = os.path.join(OUT_DIR, f"guard_trip_{i}.pt")
        torch.save({"H": H.cpu(), "keywords": kw, "label": label}, path)
        readings = []
        for name, (r, solve_leaf) in setups.items():
            graphs.clear()  # a replay keeps the rule it was captured with
            jacobi.route, jacobi.batched_eigh_leaf = r, solve_leaf
            try:
                with uncounted(), warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    info = eigdc.eigh_dc(H, **{**kw, "return_info": True})[2]
                readings.append(f"{name}: bound {float(info['bound']):.2e}, orth "
                                f"{float(info['orth']):.2e}, tripped {bool(info['tripped'])}")
            finally:
                jacobi.route, jacobi.batched_eigh_leaf = rule, leaf
        graphs.clear()
        print(f"{label}: guard trip {i}, Gram {tuple(H.shape)} with {kw}, kept in {path}; "
              "solved again: " + "; ".join(readings), flush=True)


def launches_of(jc, fn):
    """``(fn(), window-kernel launches during it)``, the counts set to 0
    just before (:func:`counts_of`)."""
    out, (window, _) = counts_of(fn)
    return out, window


def counts_of(fn):
    """``(fn(), (window-kernel launches, leaf-kernel launches))`` during
    ``fn``, both counts set to 0 just before."""
    import torch

    from vivit_tpu_torch.kernels import jacobi_cuda as jc
    from vivit_tpu_torch.kernels import jacobi_leaf_cuda as jl

    torch.cuda.synchronize()
    jc.LAUNCHES = jl.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, (jc.LAUNCHES, jl.LAUNCHES)


# every chain-path solve recorded by recording_eigh: (n, mode, bit-equal,
# max|replay − eager|, float64 err/tol of an unequal replay's eigenvalues)
REPLAYS = []
# every entry-point call recorded by recording_eigh that replayed its graphs:
# (bit-equal to its eager body, max|replay − eager| / max|eager|)
ENTRY_REPLAYS = []
# the bar of an entry replay that is not bit-equal to its eager body (cuDNN's
# default algorithms), max|Δ| / max|eager|: twice LOBPCG_STEP_ATOL, the
# loosest float64 gate a phase holds an entry's output to, as each of the
# two results meets it
ENTRY_BAR = 2 * 7.7e-4


@contextmanager
def eager_entries():
    """Inside the block, the entry points run their bodies eagerly, as
    before their calls were captured (a chain-path solve in them still
    replays its own graphs unless :func:`eager_body` is on too)."""
    from vivit_tpu_torch.utils import graphs

    stage = graphs.stage
    graphs.stage = lambda key, body, X, y, params, route: (body(X, y, params), False)
    try:
        yield
    finally:
        graphs.stage = stage


@contextmanager
def uncounted():
    """Inside the block, neither kernel's launches are counted."""
    from vivit_tpu_torch.kernels import jacobi_cuda as jc
    from vivit_tpu_torch.kernels import jacobi_leaf_cuda as jl

    launches = jc.LAUNCHES, jl.LAUNCHES
    try:
        yield
    finally:
        jc.LAUNCHES, jl.LAUNCHES = launches


def recording_eigh(fn):
    """``(fn(), batches)``: ``fn`` runs as it does, its entry points and
    chain-path eigdc solves replayed from their CUDA graphs.  A replayed
    entry point runs no Python of its solves, so ``fn`` then runs once more
    with the entry points' bodies eager (:func:`eager_entries`), its
    launches uncounted, and its result is held against the replay's
    (:data:`ENTRY_REPLAYS`); what the caller records around ``fn`` comes
    from that run too.  Each chain-path solve that runs from Python
    replays its own graphs and runs once more through the eager body with
    the same matrix and seed, uncounted, where every batch ``batched_eigh``
    receives is recorded, cloned, in call order, and the replay is held
    against it (:data:`REPLAYS`).  A strip-path solve runs eagerly and is
    recorded as it runs."""
    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch.utils import graphs

    batches = []
    recording = [True]
    solve, captured, stage = eigdc.batched_eigh, eigdc._solve_captured, graphs.stage
    replays = []

    def record(A):
        if recording[0]:
            batches.append(A.clone())
        return solve(A)

    def replayed(H, seed, *args):
        recording[0] = False
        try:
            out = captured(H, seed, *args)
        finally:
            recording[0] = True
        with uncounted():
            REPLAYS.append(replay_against_eager(H, out, eigdc._solve_eager(H, seed, *args)))
        return out

    def noted(*args):
        out = stage(*args)
        replays.append(out[1])
        return out

    eigdc.batched_eigh, eigdc._solve_captured, graphs.stage = record, replayed, noted
    try:
        out = fn()
        if any(replays):
            with uncounted(), eager_entries():
                ENTRY_REPLAYS.append(entry_against_eager(out, fn()))
    finally:
        eigdc.batched_eigh, eigdc._solve_captured, graphs.stage = solve, captured, stage
    return out, batches


def entry_against_eager(out, ref):
    """``(bit-equal, max|Δ| / max|ref|)`` of an entry point's replayed result
    against its eager body's."""
    import torch

    pairs = list(zip(flat_tensors(out), flat_tensors(ref)))
    check(pairs and len(pairs) == len(flat_tensors(ref)), "the replay's result has another form")
    equal = all(torch.equal(a, b) for a, b in pairs)
    scale = max(max(b.double().abs().max().item() for _, b in pairs), 1e-30)
    return equal, max((a.double() - b.double()).abs().max().item() for a, b in pairs) / scale


def replay_against_eager(H, out, ref):
    """``(n, mode, bit-equal, max|Δ|, err/tol)`` of a replayed solve's
    ``(evals, evecs, bound, orth, nan)`` against the eager body's; an unequal
    replay's eigenvalues are held to float64's bar (err/tol ≤ 1)."""
    import torch

    pairs = [(a, b) for a, b in zip(out, ref) if a is not None]
    equal = all(torch.equal(a, b) for a, b in pairs)
    diff = max((a.double() - b.double()).abs().max().item() for a, b in pairs)
    ratio = 0.0
    if not equal:
        ratio = spectrum_ratio(out[0], torch.linalg.eigvalsh(H.double()))[0]
        check(ratio <= 1.0, f"replayed {H.shape[0]}² solve off float64 ({ratio:.2f} of the bar)")
    return H.shape[0], "eigenpairs" if out[1] is not None else "eigenvalues", equal, diff, ratio


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
    (evals, leaves), (launches, leaf_launches) = counts_of(lambda: untripped(entry, label))
    vt, w, gram_d = deflated_gram(model, loss, X, y)
    with full_f32():
        (ev_d, V_d, info), batches = recording_eigh(
            lambda: eigdc.eigh_dc(gram_d, return_info=True))
    torch.cuda.synchronize()
    time_leaves(batches, label, leaf_launches, eager=gram_d.shape[0] >= eigdc.STRIP_MIN)
    print(f"{label}: deflated Gram {tuple(gram_d.shape)}, Jacobi launches {launches}, "
          f"guard tripped {bool(info['tripped'])} (bound {float(info['bound']):.2e}, "
          f"orth {float(info['orth']):.2e}), top-{TOP_K} "
          f"{[round(v, 6) for v in evals.tolist()]}", flush=True)
    check(launches == expect_launches,
          f"{label}: expected {expect_launches} Jacobi launches, got {launches}")
    if n == N:  # the chain path's leaves [14,150,150]; the tail and bottom block are larger
        check(leaf_launches == 1, f"{label}: expected 1 leaf-kernel launch, got {leaf_launches}")
    check(not bool(info["tripped"]), f"{label}: the eigdc guard tripped")
    check(evals.shape == (TOP_K,) and bool(torch.isfinite(evals).all()),
          f"{label}: eigenvalues {evals}")
    paths = [name for name, _ in model.named_parameters()]
    check_eigenpairs(label, evals, leaves, paths, vt, w, gram_d, ev_d, V_d)
    return (X, y, loss), launches, (gram_d, ev_d, V_d), batches


def time_windows(jc, batches, label, timed=True, reps=30, calls=10):
    """The Jacobi kernel on the window batches of a solve (those
    ``batched_eigh`` sends it): against its plain version (equal sweeps; the
    plain version's one call timed), its time beside ``torch.linalg.eigh``
    (``calls`` back to back, median of ``reps``) and its bound; prints and
    returns the totals as the fields of the ``kernels`` line (``timed=False``
    checks alone)."""
    import torch

    from vivit_tpu_torch.kernels.jacobi import jacobi_supported

    totals = dict(launches=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                  bound_by=None, library_ms=0.0)
    for A in (A for A in batches if jacobi_supported(A.shape, A.dtype)):
        b, m, _ = A.shape
        ev, V, sw = jc.batched_eigh_jacobi_cuda(A, return_sweeps=True)
        (ev_p, V_p, sw_p), t_p = cuda_once(lambda: jc.batched_eigh_jacobi_plain(
            A, exit_early=True, return_sweeps=True))
        check(torch.equal(sw, sw_p), f"{label} window [{b},{m},{m}]: sweeps differ")
        gap = max((ev - ev_p).abs().max().item(), (V - V_p).abs().max().item())
        check(gap <= 1e-5 * A.abs().max().item(),
              f"{label} window [{b},{m},{m}]: kernel and plain differ by {gap:.2e}")
        totals["launches"] += 1
        totals["max_abs_err"] = max(totals["max_abs_err"], gap)
        line = (f"{label} window [{b},{m},{m}]: sweeps run {int(sw.min())}-{int(sw.max())}"
                f" (plain the same), max|kernel-plain| {gap:.3e}")
        if timed:
            t_k = cuda_ms(lambda: jc.batched_eigh_jacobi_cuda(A), reps=reps, calls=calls)
            t_l = cuda_ms(lambda: torch.linalg.eigh(A), reps=reps, calls=calls)
            bound, by = jc.bound_ms(b, m, int(sw.sum()), PEAK_F32_FLOPS, PEAK_BYTES)
            for key, t in (("ms", t_k), ("library_ms", t_l), ("bound_ms", bound),
                           ("plain_ms", t_p)):
                totals[key] += t
            totals["bound_by"] = by
            line += (f", kernel {t_k:.4f} ms, torch.linalg.eigh {t_l:.4f} ms (median "
                     f"of {reps} runs of {calls} calls), plain {t_p:.3f} ms, bound "
                     f"{bound:.6f} ms ({by})")
        print(line, flush=True)
    if timed:
        print(f"{label}, its {totals['launches']} window launches: kernel "
              f"{totals['ms']:.4f} ms, torch.linalg.eigh {totals['library_ms']:.4f} ms, "
              f"bound {totals['bound_ms']:.6f} ms, plain {totals['plain_ms']:.3f} ms",
              flush=True)
    return totals


# the leaf kernel's shape sweep: one matrix, one per SM at b=16 and 132;
# m odd (95, padded), between the window sizes, the leaves' 150, the edge 160
LEAF_SWEEP = [(b, m) for m in (40, 95, 96, 128, 150, 160) for b in (1, 16, 132)]
# the leaf kernel's rows of the kernels line, by path (:func:`time_leaves`)
LEAF_ROWS = {}


def check_leaf(A, ev, V, label):
    """BASELINE's bars against float64, per matrix: eigenvalues within
    ``ATOL·λmax + RTOL·|λ|``, ``‖Av − λv‖ ≤ RES_RTOL·λmax`` for every vector,
    ``max|VᵀV − I| ≤ RES_RTOL``; returns the three readings (eigenvalue
    err/tol, residual/λmax, orthonormality)."""
    import torch

    A64, V64, ev64 = A.double(), V.double(), ev.double()
    ref = torch.linalg.eigvalsh(A64)
    lmax = ref.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    err = (ev64 - ref).abs()
    ratio = (err / (ATOL * lmax + RTOL * ref.abs())).max().item()
    res = (torch.linalg.vector_norm(A64 @ V64 - V64 * ev64[:, None, :], dim=1)
           / lmax).max().item()
    eye = torch.eye(A.shape[-1], dtype=torch.float64, device=A.device)
    orth = (V64.transpose(-1, -2) @ V64 - eye).abs().max().item()
    check(ratio <= 1.0, f"{label}: eigenvalues off float64 ({ratio:.2f} of the bar)")
    check(res <= RES_RTOL, f"{label}: residual {res:.2e} of λmax")
    check(orth <= RES_RTOL, f"{label}: orthonormality {orth:.2e}")
    return ratio, res, orth


def leaf_row(A, label, reps=5):
    """The leaf kernel on ``A``, uncounted: bit-equal to its plain version
    with equal sweeps, within float64's bars (:func:`check_leaf`), timed
    (CUDA events around one call, median of ``reps``) beside its plain
    version (one call), ``torch.linalg.eigh`` and its bound (the
    rotation flops of the sweeps run, at the padded m, over the f32 peak);
    prints a line and returns the fields of a ``kernels`` row."""
    import torch

    from vivit_tpu_torch.kernels import jacobi_cuda as jc
    from vivit_tpu_torch.kernels import jacobi_leaf_cuda as jl

    b, m = A.shape[0], A.shape[-1]
    with uncounted():
        ev, V, sw = jl.batched_eigh_leaf_cuda(A, return_sweeps=True)
        (ev_p, V_p, sw_p), t_p = cuda_once(lambda: jl.batched_eigh_leaf_plain(
            A, exit_early=True, return_sweeps=True))
        check(torch.equal(sw, sw_p), f"{label}: the kernel ran {sw.tolist()} sweeps, "
              f"the plain version {sw_p.tolist()}")
        gap = max((ev - ev_p).abs().max().item(), (V - V_p).abs().max().item())
        check(torch.equal(ev, ev_p) and torch.equal(V, V_p),
              f"{label}: kernel and plain version differ by {gap:.2e}")
        ratio, res, orth = check_leaf(A, ev, V, label)
        t_k = cuda_times(lambda: jl.batched_eigh_leaf_cuda(A), reps=reps)
        t_l = cuda_times(lambda: torch.linalg.eigh(A), reps=reps)
    bound, by = jc.bound_ms(b, m + m % 2, int(sw.sum()), PEAK_F32_FLOPS, PEAK_BYTES)
    print(f"{label}: sweeps run {int(sw.min())}-{int(sw.max())} (plain the same), "
          f"bit-equal to the plain version; float64: eigenvalues {ratio:.3f} of the bar, "
          f"residual {res:.2e}, orthonormality {orth:.2e}; kernel {spread(t_k)}, "
          f"torch.linalg.eigh {spread(t_l)} (CUDA events, median [min-max] of {reps}), "
          f"kernel/eigh "
          f"{np.median(t_k) / np.median(t_l):.3f}, plain {t_p:.3f} ms, bound {bound:.6f} ms "
          f"({by}, {int(sw.sum())} matrix-sweeps)", flush=True)
    return dict(max_abs_err=gap, sweeps=int(sw.max()), ms=float(np.median(t_k)),
                plain_ms=t_p, bound_ms=bound, bound_by=by,
                library_ms=float(np.median(t_l)))


def phase_leaf_sweep():
    """The leaf kernel over :data:`LEAF_SWEEP`, random symmetric inputs, each
    shape through :func:`leaf_row`."""
    import torch

    for b, m in LEAF_SWEEP:
        A = torch.tensor(random_sym(b, m, seed=b * 1000 + m), device="cuda")
        leaf_row(A, f"leaf sweep [{b},{m},{m}]")


# eigh_dc's direct solve (n ≤ 160): (window, leaf) kernel launches by n; a
# window size stays the vendor's, as the JAX package's direct solve
DIRECT_SOLVES = {64: (0, 0), 96: (0, 1), 160: (0, 1)}


def phase_direct_solves():
    """``eigh_dc``'s direct solve at each n of :data:`DIRECT_SOLVES`, both
    modes, on a Gram-like matrix (numpy, seeded): the kernels' launches,
    float64's bars (:func:`check_leaf`), the leaf route bit-equal to the
    kernel on ``H[None]``; then captured whole (``graphs.run``): no eager
    step on the leaf route (the vendor's one at a window size), the replay
    bit-equal to the eager call with the same launches."""
    import torch

    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch.kernels import jacobi_leaf_cuda as jl
    from vivit_tpu_torch.utils import graphs

    for n, expect in DIRECT_SOLVES.items():
        rng = np.random.default_rng(n)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = np.exp(-np.linspace(0, 11, n)) * 250.0 + 1e-7
        H = torch.tensor(((Q * lam) @ Q.T).astype(np.float32), device="cuda")
        Hs = (0.5 * (H + H.T))[None]
        for vectors in (False, True):
            label = f"eigh_dc direct solve {n}² ({'eigenpairs' if vectors else 'eigenvalues'})"

            def body(gen, H):
                return eigdc.eigh_dc(H, eigenvectors=vectors)

            (ev, V), counts = counts_of(lambda: body(None, H))
            check(counts == expect, f"{label}: (window, leaf) launches {counts}, "
                  f"expected {expect}")
            if vectors:
                ratio, res, orth = check_leaf(Hs, ev[None], V[None], label)
                bars = (f"eigenvalues {ratio:.3f} of the bar, residual {res:.2e}, "
                        f"orthonormality {orth:.2e}")
            else:
                ref = torch.linalg.eigvalsh(Hs[0].double())
                ratio = ((ev.double() - ref).abs()
                         / (ATOL * ref.abs().max() + RTOL * ref.abs())).max().item()
                check(ratio <= 1.0, f"{label}: eigenvalues off float64 ({ratio:.2f} of the bar)")
                bars = f"eigenvalues {ratio:.3f} of the bar"
            if expect[1]:
                with uncounted():
                    want = [x[0] for x in jl.batched_eigh_leaf_cuda(Hs)]
                check(torch.equal(ev, want[0]) and (V is None or torch.equal(V, want[1])),
                      f"{label}: not the leaf kernel's result on H[None]")
            key = ("chip_smoke direct solve", n, vectors)
            with uncounted():
                graphs.run(key, body, (H,), 0)  # the capture
            steps = [list(st.args[0].shape) for st in graphs.entries()[key].steps]
            (ev_r, V_r), replayed = counts_of(lambda: graphs.run(key, body, (H,), 0))
            check(len(steps) == (0 if expect[1] else 1),
                  f"{label}: captured with eager steps {steps}")
            check(replayed == expect, f"{label}: the replay launched {replayed}")
            check(torch.equal(ev_r, ev) and (V is None or torch.equal(V_r, V)),
                  f"{label}: the replay differs from the eager call")
            print(f"{label}: (window, leaf) launches {counts}, float64: {bars}"
                  f"{', bit-equal to the leaf kernel on H[None]' if expect[1] else ''}; "
                  f"captured with eager steps {steps}, the replay bit-equal with the same "
                  "launches", flush=True)


def time_leaves(batches, label, launches, eager=False):
    """The leaf kernel on the leaf and edge blocks of a solve (the batches
    ``batched_eigh`` routes to it; ``eager``: a strip-path solve, which
    routes them as solved outside any graph), each through
    :func:`leaf_row`; the path's launches, read from its own run, must be
    their number.  Keeps the sums as the path's row of the ``kernels``
    line (:data:`LEAF_ROWS`).  The single blocks of the leaf range that
    the path sends to the vendor go through :func:`leaf_row` too, for the
    record."""
    from vivit_tpu_torch.kernels.jacobi import leaf_supported, route

    leaves = [A for A in batches if route(A.shape, A.dtype, A.device, eager) == "leaf"]
    shapes = [list(A.shape) for A in leaves]
    check(launches == len(leaves), f"{label}: {launches} leaf-kernel launches, but the "
          f"solve hands the leaf route {len(leaves)} batches {shapes}")
    for A in batches:
        if route(A.shape, A.dtype, A.device, eager) == "vendor" and leaf_supported(
                A.shape, A.dtype):
            leaf_row(A, f"{label} vendor batch {list(A.shape)} (single, outside graphs)")
    if not leaves:
        print(f"{label}: no batch on the leaf route", flush=True)
        return
    totals = dict(launches=launches, batches=shapes, max_abs_err=0.0, sweeps=0, ms=0.0,
                  plain_ms=0.0, bound_ms=0.0, bound_by=None, library_ms=0.0)
    for A, shape in zip(leaves, shapes):
        row = leaf_row(A, f"{label} leaf batch {shape}")
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            totals[key] += row[key]
        totals["max_abs_err"] = max(totals["max_abs_err"], row["max_abs_err"])
        totals["sweeps"] = max(totals["sweeps"], row["sweeps"])
        totals["bound_by"] = row["bound_by"]
    print(f"{label}, its {launches} leaf-kernel launches {shapes}: kernel "
          f"{totals['ms']:.4f} ms, torch.linalg.eigh {totals['library_ms']:.4f} ms, bound "
          f"{totals['bound_ms']:.6f} ms, plain {totals['plain_ms']:.3f} ms", flush=True)
    LEAF_ROWS[label] = totals


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
    time_windows(jc, batches, "refine_eigh")
    return launches


def phase_spectrum_large(jc, model, expect_launches):
    """``eigvalsh_structured`` at N=512 (the strip path), its w=64 windows
    through the kernel and its plain version, timed; returns its launches,
    inputs and the window totals of :func:`time_windows`."""
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
    ((evals,), (info,)), (launches, leaf_launches) = counts_of(entry)
    n_zero = int((evals == 0).sum())
    print(f"{label}: {evals.numel()} eigenvalues, {n_zero} exact zeros, Jacobi launches "
          f"{launches}, guard tripped {bool(info['tripped'])} (bound "
          f"{float(info['bound']):.2e}, orth {float(info['orth']):.2e})", flush=True)
    check(launches == expect_launches,
          f"{label}: expected {expect_launches} Jacobi launches, got {launches}")
    check(not bool(info["tripped"]), f"{label}: the eigdc guard tripped")
    check(evals.numel() == n * NUM_CLASSES, f"{label}: {evals.numel()} eigenvalues")
    check(bool(torch.isfinite(evals).all()), f"{label}: non-finite eigenvalues")
    check(n_zero == n, f"{label}: {n_zero} exact zeros, expected {n}")

    with full_f32():
        vt = tapped_ggn_sqrt_vt(model, loss, X, y, deflate_ce_null=True)
        gram = gram_matrix_mixed(vt, generic_precision=_PRECISIONS["bf16"])
        (ev_dc, info_dc), batches = recording_eigh(
            lambda: eigdc.eigvalsh_dc(gram, return_info=True))
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
    time_leaves(batches, label, leaf_launches, eager=True)
    # eigh's ~30 ms per window batch: one call per run, median of 5
    return launches, (X, y, loss), time_windows(jc, batches, label, reps=5, calls=1)


def phase_times(model, inputs_small, inputs_large, spectrum_inputs):
    """Times of the new entries and their stages, and one profiled N=512
    eigenpair call."""
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


def newton_step(model, loss, X, y, solver):
    """The bench leg's ``newton_step_structured`` (k=10, damping 1, bf16
    Gram, CE deflation) with ``solver``, replayed from its graphs."""
    import vivit_tpu_torch as vtt

    return vtt.newton_step_structured(model, loss, X, y, TOP_K, damping=1.0,
                                      solver=solver, **HEADLINE)


def newton_intermediates(model, loss, X, y, solver):
    """``(Vᵀ, the arguments and result of its gammas_lambdas, its LOBPCG
    solves)`` of one more call of :func:`newton_step`'s eager body (a
    replay runs none of the Python that records them), uncounted."""
    from vivit_tpu_torch import lobpcg, structured
    from vivit_tpu_torch.optim import utils as optim_utils

    with recorded(structured, "gram_matrix_mixed") as grams, \
            recorded(optim_utils, "gammas_lambdas") as derivs, \
            recorded(lobpcg, "lobpcg_standard") as solves, uncounted(), eager_entries():
        newton_step(model, loss, X, y, solver)
    check(len(grams) == 1 and len(derivs) == 1, "one Gram and one γ/λ per step")
    return grams[0][0][0], derivs[0], solves


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
        (step, batches), launches[solver] = launches_of(
            jc, lambda: recording_eigh(lambda: untripped(
                lambda: newton_step(model, loss, X, y, solver), label)))
        vt, derivs, solves = newton_intermediates(model, loss, X, y, solver)
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
            time_windows(jc, batches, label)
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


def three_pass_operands(a_shape, b_shape, generator):
    """``(a, b)`` of a :data:`THREE_PASS_SHAPES` entry, normal draws on the
    generator's card: ``b_shape`` None a squaring (``b is a``), ``a_shape``
    None a ``Yᵀ Y`` (``a`` the transposed view of ``b``)."""
    import torch

    def draw(shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    if a_shape is None:
        b = draw(b_shape)
        return b.mT, b
    a = draw(a_shape)
    return a, (a if b_shape is None else draw(b_shape))


def cublas_three_pass(a, b):
    """The three TF32 passes as cuBLAS ran them before the kernel: each
    operand split (``precision.tf32_split``, copies in device memory),
    ``hi·lo`` and ``lo·hi``, then ``hi·hi`` in k-chunks of 384, summed into
    one f32 output with TF32 on: phase 17's ``library_ms`` yardstick, which
    the port never calls."""
    import torch

    from vivit_tpu_torch.precision import tf32_split

    hi_b, lo_b = tf32_split(b)
    hi_a, lo_a = (hi_b, lo_b) if a is b else tf32_split(a)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = torch.matmul(hi_a, lo_b)
        out += torch.matmul(lo_a, hi_b)
        for k0 in range(0, a.shape[-1], 384):
            out += torch.matmul(hi_a[..., k0:k0 + 384], hi_b[..., k0:k0 + 384, :])
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def phase_three_pass(model):
    """Phase 17: the three-pass kernel against the f32 product, its plain
    version, the cuBLAS passes and float64 (module docstring); returns its
    rows of the kernels line: the strip path's, then one a shape."""
    import torch

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import eigdc, precision
    from vivit_tpu_torch.kernels import three_pass as tp
    from vivit_tpu_torch.precision import full_f32

    gen = torch.Generator(device="cuda").manual_seed(0)
    loss = vtt.CrossEntropyLoss("mean")

    # the strip path: one eigvalsh_dc of the deflated N=512 Gram, the
    # counters set to 0 just before it
    _, _, H = deflated_gram(model, loss, *port_batch(N_LARGE))
    torch.cuda.synchronize()
    precision.THREE_PASS = precision.THREE_PASS_DECLINED = tp.LAUNCHES = 0
    t0 = time.perf_counter()
    eigdc.eigvalsh_dc(H)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    engaged, declined, launches = precision.THREE_PASS, precision.THREE_PASS_DECLINED, tp.LAUNCHES
    print(f"three-pass strip path, eigvalsh_dc {tuple(H.shape)}: {engaged} products engaged, "
          f"{launches} kernel launches, {declined} declined; {solve_ms:.1f} ms", flush=True)
    check(engaged > 0 and launches == engaged,
          f"strip path: {launches} kernel launches for {engaged} engaged products")
    rows = [{"path": f"eigvalsh_dc N={N_LARGE} (strip path, one solve)", "launches": launches,
             "engaged": engaged, "declined": declined, "solve_ms": solve_ms}]
    del H

    def bf16x3(a, b):
        """The JAX package's ``"high"`` in the card's terms, for its error."""
        ha, hb = a.bfloat16(), b.bfloat16()
        la, lb = (a - ha.float()).bfloat16(), (b - hb.float()).bfloat16()
        parts = [(ha, lb), (la, hb), (ha, hb)]
        if a.dim() == 3:
            return sum(torch.stack([torch.mm(x, y, out_dtype=torch.float32)
                                    for x, y in zip(p, q)]) for p, q in parts)
        return sum(torch.mm(x, y, out_dtype=torch.float32) for x, y in parts)

    def rel(x, ref):
        return float(torch.linalg.vector_norm((x.double() - ref).flatten())
                     / torch.linalg.vector_norm(ref.flatten()))

    def timed(a, b, cublas=True):
        """(f32 ms, kernel ms, cuBLAS passes ms), in turns, each the median
        of 10 (the cuBLAS passes left out of the sweep)."""
        with full_f32():
            f32 = [cuda_ms(lambda: a @ b, 5) for _ in range(2)]
            kernel = [cuda_ms(lambda: tp.three_pass_cuda(a, b), 5) for _ in range(2)]
            lib = [cuda_ms(lambda: cublas_three_pass(a, b), 5) for _ in range(2)] if cublas else [0]
        return float(np.median(f32)), float(np.median(kernel)), float(np.median(lib))

    slower = []  # engaged shapes where the kernel loses
    for label, a_shape, b_shape in THREE_PASS_SHAPES:
        a, b = three_pass_operands(a_shape, b_shape, gen)
        ref = a.double() @ b.double()
        before = tp.LAUNCHES
        got = tp.three_pass_cuda(a, b)
        torch.cuda.synchronize()
        launches = tp.LAUNCHES - before
        with full_f32():
            t0 = time.perf_counter()
            plain = tp.three_pass_plain(a, b)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            errs = [rel(x, ref) for x in (a @ b, got, bf16x3(a, b), cublas_three_pass(a, b))]
        vs_plain = rel(got, plain.double())
        f32_ms, ms, lib_ms = timed(a, b)
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        batch = a.shape[0] if a.dim() == 3 else 1
        flops = 2.0 * m * n * k * batch
        # the least time: three TF32 passes at the peak, or the operands in
        # and the output out once
        bound_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
        bound_bytes = 4.0 * batch * (m * k + k * n + m * n) / PEAK_BYTES * 1e3
        print(f"three-pass {label}: kernel {launches} launch, error vs float64 {errs[1]:.3e} "
              f"(f32 {errs[0]:.3e}, ratio {errs[1] / errs[0]:.3f}; cuBLAS passes {errs[3]:.3e}; "
              f"bf16_3x {errs[2]:.3e}); vs its plain version {vs_plain:.3e}; kernel {ms:.4f} ms "
              f"({3 * flops / ms / 1e9:.1f} TFLOP/s of TF32, bound {max(bound_ops, bound_bytes):.4f}"
              f" ms by {'operations' if bound_ops >= bound_bytes else 'bytes'}), cuBLAS passes "
              f"{lib_ms:.4f} ms, f32 {f32_ms:.4f} ms ({flops / f32_ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.1f} ms; kernel {lib_ms / ms:.3f}x the cuBLAS passes, "
              f"{f32_ms / ms:.3f}x f32", flush=True)
        check(launches == 1, f"three-pass {label}: {launches} kernel launches")
        check(errs[1] <= 2 * errs[0],
              f"three-pass {label}: error {errs[1]:.3e}, the f32 product's {errs[0]:.3e}")
        check(vs_plain <= 4 * errs[0],
              f"three-pass {label}: {vs_plain:.3e} off its plain version")
        if min(m, k, n) >= precision.THREE_PASS_MIN and not (ms < lib_ms and ms < f32_ms):
            slower.append(f"{label}: {ms:.4f} ms, cuBLAS passes {lib_ms:.4f} ms, f32 "
                          f"{f32_ms:.4f} ms")
        rows.append({"path": f"one call, {label}", "launches": launches, "ms": ms,
                     "plain_ms": plain_ms,
                     "bound_ms": max(bound_ops, bound_bytes),
                     "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
                     "library_ms": lib_ms, "f32_ms": f32_ms, "error": errs[1],
                     "f32_error": errs[0]})
        del a, b, ref, got, plain
    check(not slower, f"the kernel no faster where the product engages: {slower}")

    crossovers = {}
    for batch in ((), (2,)):
        wins = []
        for n in THREE_PASS_SWEEP:
            a, b = three_pass_operands(batch + (n, n), batch + (n, n), gen)
            f32_ms, ms, _ = timed(a, b, cublas=False)
            wins.append(ms < f32_ms)
            print(f"three-pass sweep {list(batch + (n, n))}: f32 {f32_ms:.4f} ms, kernel "
                  f"{ms:.4f} ms, {f32_ms / ms:.3f}x", flush=True)
        # the least size from which the kernel wins at every larger size swept
        losing = [n for n, w in zip(THREE_PASS_SWEEP, wins) if not w]
        crossovers[f"{list(batch + ('n', 'n'))}"] = next(
            (n for n in THREE_PASS_SWEEP if not losing or n > max(losing)), None)
    print(f"three-pass kernel crossovers against the f32 product: {crossovers}; "
          f"THREE_PASS_MIN {precision.THREE_PASS_MIN}", flush=True)

    X, y = port_batch(N)
    before = (precision.THREE_PASS, precision.THREE_PASS_DECLINED, tp.LAUNCHES)
    with deterministic_cudnn():
        vtt.eigvalsh_structured(model, loss, X, y, eig_backend="dc", **HEADLINE)
        vtt.eigh_topk(model, loss, X, y, TOP_K, solver="dc", **HEADLINE)
    torch.cuda.synchronize()
    after = (precision.THREE_PASS, precision.THREE_PASS_DECLINED, tp.LAUNCHES)
    print(f"three-pass counters (engaged, declined, kernel launches) over the N={N} headline "
          f"and eigh_topk: {before} -> {after}", flush=True)
    check(after == before, f"an N={N} call reached a \"high\" product: {before} -> {after}")
    return rows


def token_chunk(label, leaf, c, per_query):
    """One chunk ``c`` of token block ``leaf`` (random factors on the card):
    the f32 ``bmm`` of ``TokenFactor.expand`` (TF32 off) timed first, then
    the kernel (its first call, its launches: one a range of
    :data:`TOKEN_ROWS` positions; its time and bound), its plain version,
    their errors against float64 and the bf16 roundings against the
    ``bmm``'s, held to the bars of the module docstring; ``per_query``
    chunks of this shape a query.  Returns its row of the kernels line."""
    import torch

    from vivit_tpu_torch.kernels import token_expand as te
    from vivit_tpu_torch.precision import full_f32

    def rel(x, ref):
        return float(torch.linalg.vector_norm((x.double() - ref).flatten())
                     / torch.linalg.vector_norm(ref.flatten()))

    cf, s, t, _ = leaf.delta.shape
    cols, oc, ic = leaf.num_cols, c[1] - c[0], c[3] - c[2]
    ranges = -(-t // TOKEN_ROWS[te._width(ic)])

    def kernel():
        return te.token_expand_cuda(leaf.z, leaf.delta, *c)

    with full_f32():  # the route before the kernel, timed first
        bmm_ms = cuda_ms(lambda: leaf.expand(*c), 5)
        bmm = leaf.expand(*c).flatten(0, 1)
    before = te.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = kernel()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = te.LAUNCHES - before
    check(launches == ranges, f"token {label}: {launches} launches, not {ranges}")
    kernel_ms = cuda_ms(kernel, 10)
    with full_f32():
        plain_ms = cuda_ms(lambda: te.token_expand_plain(leaf.z, leaf.delta, *c), 2,
                           warmup=1)
        plain = te.token_expand_plain(leaf.z, leaf.delta, *c)
    d, z = leaf.delta[..., c[0]:c[1]].double(), leaf.z[..., c[2]:c[3]].double()
    ref = torch.einsum("cnpo,npi->cnoi", d, z).flatten(0, 1)
    del d, z
    err, err_bmm, err_plain = rel(got, ref), rel(bmm, ref), rel(plain, ref)
    vs_plain = rel(got, plain.double())
    del plain
    share = float((got.bfloat16() != bmm.bfloat16()).double().mean())
    apart, apart_f32 = te.bf16_apart(got, bmm), te.bf16_apart(bmm, ref)
    floor = float(apart.max()) if apart.numel() else 0.0
    f32_err = float((bmm.double() - ref).abs().max())
    del got, bmm, ref
    flops = 3 * 2.0 * cols * t * oc * ic
    nbytes = 4.0 * (cols * oc * ic + cf * s * t * oc + s * t * ic)
    bound_ms = max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    print(f"token expansion {label}: chunk [{cols}, {oc}, {ic}] over {t} positions, "
          f"{per_query} a query; f32 bmm {bmm_ms:.4f} ms; kernel {kernel_ms:.4f} ms "
          f"({flops / kernel_ms / 1e9:.1f} TFLOP/s TF32, {bmm_ms / kernel_ms:.3f}x the "
          f"bmm; {launches} launches), first call {first_s:.2f} s; bound {bound_ms:.4f} ms "
          f"({'operations' if flops / PEAK_TF32_FLOPS >= nbytes / PEAK_BYTES else 'bytes'}"
          f", {100 * bound_ms / kernel_ms:.1f}%); plain {plain_ms:.2f} ms; error vs "
          f"float64 {err:.3e} (bmm {err_bmm:.3e}, ratio {err / err_bmm:.3f}; plain "
          f"{err_plain:.3e}); kernel vs plain {vs_plain:.3e}; bf16 roundings that "
          f"differ {100 * share:.4f}%, {apart.numel()} of them not neighbours, all of "
          f"|x| <= {floor:.3e} (2^8 x the bmm's largest error: {2 ** 8 * f32_err:.3e}; "
          f"bmm against float64: {apart_f32.numel()} not neighbours)", flush=True)
    check(err <= 2 * err_bmm, f"token {label}: error {err:.3e}, the bmm's {err_bmm:.3e}")
    check(vs_plain <= 4 * err_bmm, f"token {label}: {vs_plain:.3e} off its plain version")
    check(share <= 1 - TOKEN_BF16_EQUAL and floor <= 2 ** 8 * f32_err,
          f"token {label}: {100 * share:.4f}% of bf16 roundings differ, non-neighbours up "
          f"to |x| {floor:.3e}")
    return {"launches": launches, "chunk": [cols, oc, ic], "positions": t,
            "per_query": per_query, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": bmm_ms, "bound_ms": bound_ms, "rel_err": err,
            "bmm_rel_err": err_bmm, "bf16_differ_share": share}


def phase_token_expand():
    """Phase 18: the token expansion's kernel against the f32 ``bmm``, its
    plain version and float64 at ViT-S/16's and Moonlight-16B-A3B's chunks
    (module docstring); returns its rows of the kernels line, one a layer."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vivit_tpu_torch.kernels import token_expand as te
    from vivit_tpu_torch.structured import TokenFactor

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, i, o in TOKEN_LAYERS:
        leaf = TokenFactor(
            z=torch.randn((N, TOKEN_T, i), generator=gen, device="cuda"),
            delta=1e-3 * torch.randn((TOKEN_CF, N, TOKEN_T, o), generator=gen, device="cuda"))
        chunks = leaf._chunks()
        check(len({(o1 - o0, i1 - i0) for o0, o1, i0, i1 in chunks}) == 1,
              f"token {name}: chunks of several shapes {chunks}")
        row = token_chunk(f"{name} (in {i}, out {o})", leaf, chunks[0],
                          len(chunks) * TOKEN_DEPTH)

        want = leaf.gram(torch.bfloat16)
        before = te.LAUNCHES
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(TOKEN_LEAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            got = leaf.gram(torch.bfloat16)
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        traced = sum(e.count for e in device if "token_expand_kernel" in e.key)
        lead = sum(e.count for e in device if "spin_kernel" in e.key)
        launches, same = te.LAUNCHES - before, bool(torch.equal(got, want))
        del got, want
        print(f"token expansion {name}: a bf16 Gram: {launches} launches, {traced} in the "
              f"trace ({TOKEN_LEAD - lead} of the {TOKEN_LEAD} lead-in records dropped), "
              f"bit-equal to an unprofiled Gram {same}", flush=True)
        check(launches == traced == len(chunks) and same,
              f"token {name}: launches {launches}, traced {traced}, chunks {len(chunks)}, "
              f"equal to an unprofiled Gram {same}")
        rows.append({"path": f"TokenFactor.gram ViT-S/16 {name} N={N}", **row})
        del leaf
        torch.cuda.empty_cache()
    query = token_query("ViT-S/16, 12 blocks", rows)
    check(query["ms"] < query["library_ms"], f"token expansion ViT-S/16: {query}")
    rows += token_lm()
    token_capture()
    return rows


def token_query(label, rows):
    """The kernel's, the ``bmm``'s and the bound's time a query, each
    chunk's times its count a query, printed and returned."""
    query = {key: sum(r[key] * r["per_query"] for r in rows)
             for key in ("library_ms", "ms", "bound_ms")}
    print(f"token expansion a query ({label}): f32 bmm {query['library_ms']:.2f} ms, kernel "
          f"{query['ms']:.2f} ms, bound {query['bound_ms']:.2f} ms "
          f"({100 * query['bound_ms'] / query['ms']:.1f}%)", flush=True)
    return query


def bench_module(kind, name):
    """``benchmark/<kind>/<name>``: a network module (``.py``) loaded by
    path, or a configuration (``.json``) read."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark", kind, name)
    if name.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name[:-3]}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def lm_routed_samples():
    """The samples of the rows that the first MoE layer of Moonlight-16B-A3B
    (``benchmark/networks/moonlight.py`` at the LM cell's configuration,
    cut to its first two layers, weights drawn from seed 0) routes to
    expert 0 on a batch of :data:`TOKEN_LM_S` × :data:`TOKEN_LM_T` normals:
    a recorded routing, ``[rows]`` of sample ids."""
    import torch

    from vivit_tpu_torch.precision import full_f32

    moonlight = bench_module("networks", "moonlight.py")
    cfg = {**bench_module("configs", "moonlight_16b_a3b_l5_e8.json"), "num_hidden_layers": 2}
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = moonlight.build(cfg, torch.device("cuda"), gen)
    X = torch.randn((TOKEN_LM_S, TOKEN_LM_T), generator=gen, device="cuda")
    with full_f32(), torch.no_grad():
        net(X)
    choice = net.routing["recorded"][0]
    del net
    torch.cuda.empty_cache()
    tokens = (choice == 0).any(dim=-1).nonzero().squeeze(-1)
    return tokens // TOKEN_LM_T


def token_lm():
    """Phase 18 at the LM cell: the first chunk of each token block shape
    (:data:`TOKEN_LM_LAYERS`, 16 columns over 2,048 positions: the kernel's
    range loop), then an expert's block over the per-sample segments of a
    recorded routing (:func:`lm_routed_samples`), padded with zero rows to
    the longest (``structured.routed_factor``), also held to the float64
    block of the ragged segments; each a row of the kernels line."""
    import torch

    from vivit_tpu_torch import structured
    from vivit_tpu_torch.kernels import token_expand as te
    from vivit_tpu_torch.structured import TokenFactor

    gen = torch.Generator(device="cuda").manual_seed(1)
    s, t, cf = TOKEN_LM_S, TOKEN_LM_T, TOKEN_LM_CF
    rows = []
    for name, i, o, blocks in TOKEN_LM_LAYERS:
        leaf = TokenFactor(
            z=torch.randn((s, t, i), generator=gen, device="cuda"),
            delta=1e-3 * torch.randn((cf, s, t, o), generator=gen, device="cuda"))
        chunks = leaf._chunks()
        row = token_chunk(f"Moonlight {name} (in {i}, out {o})", leaf, chunks[0],
                          len(chunks) * blocks)
        rows.append({"path": f"TokenFactor.gram Moonlight-16B-A3B {name} S={s} T={t}", **row})
        del leaf
        torch.cuda.empty_cache()

    sample = lm_routed_samples()
    counts = torch.bincount(sample, minlength=s)
    longest = int(counts.max())
    print(f"token expansion Moonlight routed: expert 0 of the first MoE layer takes "
          f"{sample.numel()} rows, {int(counts.min())}-{longest} a sample", flush=True)
    check(int(counts.min()) < longest, f"routed segments of one length {longest}: no padding")
    for name, i, o, blocks in TOKEN_LM_ROUTED:
        z = torch.randn((sample.numel(), i), generator=gen, device="cuda")
        delta = 1e-3 * torch.randn((cf, sample.numel(), o), generator=gen, device="cuda")
        leaf = structured.routed_factor(z, delta, sample, s)
        check(tuple(leaf.z.shape) == (s, longest, i), f"routed {name}: {tuple(leaf.z.shape)}")
        c = leaf._chunks()[0]
        check(c == (0, o, 0, i), f"routed {name}: chunks {leaf._chunks()}")
        row = token_chunk(f"Moonlight routed {name} (in {i}, out {o})", leaf, c, blocks)
        # the ragged segments in float64: the padded rows add nothing
        got = te.token_expand_cuda(leaf.z, leaf.delta, *c).double().view(cf, s, o, i)
        ragged = torch.stack([torch.einsum("cro,ri->coi", delta[:, sample == n].double(),
                                           z[sample == n].double()) for n in range(s)], 1)
        gap = float(torch.linalg.vector_norm((got - ragged).flatten())
                    / torch.linalg.vector_norm(ragged.flatten()))
        del got, ragged
        print(f"token expansion Moonlight routed {name}: padded block against the ragged "
              f"segments' float64 {gap:.3e} (the padded float64's {row['rel_err']:.3e})",
              flush=True)
        check(gap <= 2 * row["bmm_rel_err"], f"routed {name}: {gap:.3e} off the ragged block")
        rows.append({"path": f"RoutedFactor.gram Moonlight-16B-A3B expert {name} S={s} "
                             f"L={longest}", **row, "ragged_rel_err": gap})
        del leaf, z, delta
        torch.cuda.empty_cache()
    token_query("Moonlight-16B-A3B, 40 token blocks and 96 routed blocks at one segment length",
                rows)
    return rows


# a small ViT (benchmark/networks/vit.py) whose whole call is captured
TOKEN_VIT = {"image": [32, 32, 3], "patch": 8, "width": 64, "heads": 2, "mlp": 128, "depth": 2,
             "num_classes": 10, "init": {"std": 0.02, "ln_eps": 1e-6}}


def token_capture():
    """Phase 18's capture: ``eigvalsh_structured`` of a small ViT with a
    bf16 Gram, first eagerly (the kernel once a token block, each one
    chunk; :data:`structured.TOKEN_BLOCKS`), then captured and
    replayed, each replay adding the captured launches to ``LAUNCHES``
    (registered with ``graphs.count_launches``) and equal to the eager body."""
    import torch

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import structured
    from vivit_tpu_torch.kernels import token_expand as te
    from vivit_tpu_torch.utils import graphs

    vit = bench_module("networks", "vit.py")
    gen = torch.Generator(device="cuda").manual_seed(7)
    net = vit.build(TOKEN_VIT, torch.device("cuda"), gen)
    X = torch.randn((16, *TOKEN_VIT["image"]), generator=gen, device="cuda")
    y = torch.randint(0, TOKEN_VIT["num_classes"], (16,), generator=gen, device="cuda")
    loss = vtt.CrossEntropyLoss("mean")

    def call():
        (evals,) = vtt.eigvalsh_structured(net, loss, X, y, eig_backend="dc", **HEADLINE)
        torch.cuda.synchronize()
        return evals.clone()

    graphs.clear()
    with deterministic_cudnn():
        structured.TOKEN_BLOCKS, before = 0, te.LAUNCHES
        with eager_entries():
            ref = call()
        blocks, eager = structured.TOKEN_BLOCKS, te.LAUNCHES - before
        keys = set(graphs.entries())
        call()
        captured = [k for k in graphs.entries() if k not in keys]
        mid = te.LAUNCHES
        got = call()
        replayed = te.LAUNCHES - mid
    same = bool(torch.equal(got, ref))
    gap = float((got - ref).abs().max() / ref.abs().max())
    print(f"token expansion captured: a small ViT's eigvalsh_structured (bf16 Gram), eager "
          f"{eager} launches for {blocks} token blocks of one chunk; {len(captured)} entry "
          f"captured; a replay "
          f"adds {replayed} launches; replay bit-equal to the eager body {same} "
          f"(max|Δ|/max|eager| {gap:.2e})", flush=True)
    check(blocks == eager == 4 * TOKEN_VIT["depth"] and len(captured) == 1,
          f"token capture: {blocks} blocks, {eager} eager launches, {len(captured)} entries")
    check(replayed == eager, f"token capture: a replay added {replayed} launches, not {eager}")
    check(same or gap <= ENTRY_BAR, f"token capture: replay {gap:.2e} off the eager body")
    graphs.clear()


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
    time_windows(jc, batches, label)

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
    time_windows(jc, batches, label)

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
    Returns the launches per path, the call times and the N=512 spectrum's
    window totals (:func:`time_windows`)."""
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
    time_windows(jc, batches, label)
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
    time_windows(jc, batches, label)
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
    time_windows(jc, batches, label)
    times[label] = host_ms(newton)
    del step, in_memory, step_o, derivs

    # eigvalsh_streamed N=512: the strip path, peak memory, stages
    n = N_LARGE
    X5, y5 = port_batch(n)
    label = f"eigvalsh_streamed N={n}"

    def spectrum_large():
        return chunked.eigvalsh_streamed(model_fn, loss, params, X5, y5, **settings)[0]

    # the peak below is the call's own: the cached graphs' pools go first
    release_graphs(f"{label}'s peak")
    untripped(spectrum_large, label)  # warm-up
    (((evals, gram_d), peak), launches[label]) = launches_of(jc, lambda: peak_of(
        lambda: streamed_gram_of(lambda: untripped(spectrum_large, label))))
    with full_f32():  # the entry's solve again, its batches recorded
        (_, info), batches = recording_eigh(
            lambda: eigdc.eigvalsh_dc(gram_d, return_info=True))
    print(f"{label}: Jacobi launches {launches[label]}, guard tripped {bool(info['tripped'])}, "
          f"peak memory {peak / 1e9:.3f} GB above what the call started with "
          f"(bar: the in-memory deflated Vᵀ, {STREAMED_PEAK_BAR / 1e9:.2f} GB)", flush=True)
    check(launches[label] == 4, f"{label}: expected 4 Jacobi launches, got {launches[label]}")
    check(not bool(info["tripped"]), f"{label}: the eigdc guard tripped")
    check(peak < STREAMED_PEAK_BAR, f"{label}: peak {peak / 1e9:.2f} GB")
    # eigh's ~30 ms per window batch: one call per run, median of 5
    windows = time_windows(jc, batches, label, reps=5, calls=1)
    check_spectrum(label, evals, gram_d, n)
    del gram_d, batches
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
    return launches, times, windows


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
    time_windows(jc, batches, label)
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
    time_windows(jc, batches, label, timed=False)
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
    time_windows(jc, batches, label, timed=False)
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
    time_windows(jc, batches, label, timed=False)
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
    time_windows(jc, batches, label)
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
    time_windows(jc, batches, label)
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
            p, _ = untripped(lambda: step(p, X, y), label, keep=True)
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


# eigh_dc's routes beyond its two defaults, each with the Jacobi launches of
# its polish (2·Σ wj_iters) per mode: (name, Gram, keywords, {eigenvectors:
# launches}).  "small" is N=128's Gram-level deflated 1152² Gram, "large"
# N=512's 4608² one.
ROUTES = [
    ("ladder=False", "small", {"ladder": False}, {False: 2, True: 6}),
    ("deskew_terms=4", "small", {"deskew_terms": 4}, {False: 2}),
    ("strip=1024", "small", {"strip": 1024}, {False: 4}),
    ("strip=0", "large", {"strip": 0}, {False: 2}),
    # the degraded keywords of tests/test_guard_info.py: the guard must trip
    ("forced trip", "small", {"sign_iters_root": (1, 1), "sign_iters": (1, 1),
                              "orth_iters": (1, 1), "ns_global": 0,
                              "dm_iters": (0, 0, 0), "kpm_degree": 8},
     {False: 2, True: 6}),
]
ROUTE_SWEEPS = (1, 4, 12)


def turn_times(fns, reps=5):
    """CUDA-event times of one call of each of ``fns``, ``reps`` each, in
    turns (the order reversed every other round: ``a, b, b, a, ...``),
    after one warm-up call of each."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for i in range(reps):
        for k in (range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))):
            times[k].append(cuda_once(fns[k])[1])
    return times


def spectrum_ratio(got, ref):
    """``(max err/tol, violations)`` of eigenvalues against float64 at
    BASELINE's bars."""
    err = (got.double() - ref).abs()
    tol = ATOL * ref.abs().max() + RTOL * ref.abs()
    return (err / tol).max().item(), int((err > tol).sum())


def check_route_result(label, G, ref, ev, V):
    """The eigenvalue bar against float64; with vectors, the full basis's
    orthonormality and similarity defect (the bars of
    :func:`check_eigenpairs`)."""
    import torch

    ratio, bad = spectrum_ratio(ev, ref)
    check(bad == 0, f"{label}: {bad} violations of float64 (max err/tol {ratio:.2f})")
    line = f"max err/tol {ratio:.3f}"
    if V is not None:
        G64, V64, n = G.double(), V.double(), G.shape[0]
        eye = torch.eye(n, dtype=torch.float64, device=G.device)
        orth = (torch.linalg.matrix_norm(V64.T @ V64 - eye) / n ** 0.5).item()
        defect = (torch.linalg.matrix_norm(G64 @ V64 - V64 * ev.double())
                  / torch.linalg.matrix_norm(G64)).item()
        check(orth < 1e-4, f"{label}: basis orthonormality {orth:.2e}")
        check(defect < 5e-4, f"{label}: basis defect {defect:.2e}")
        line += f", ‖VᵀV−I‖_F/√n {orth:.2e}, ‖GV−VΛ‖_F/‖G‖_F {defect:.2e}"
    return line


def check_route_sweeps(jc, batches, label):
    """The kernel at each of ``ROUTE_SWEEPS`` on the route's first window
    batch of each shape, against its plain version with the same cap: equal
    to the bit, and no matrix past the cap."""
    import torch

    from vivit_tpu_torch.kernels.jacobi import jacobi_supported

    seen = set()
    for A in batches:
        if not jacobi_supported(A.shape, A.dtype) or A.shape in seen:
            continue
        seen.add(A.shape)
        ran = []
        for s in ROUTE_SWEEPS:
            got = jc.batched_eigh_jacobi_cuda(A, return_sweeps=True, sweeps=s)
            want = jc.batched_eigh_jacobi_plain(A, exit_early=True, return_sweeps=True,
                                                sweeps=s)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"{label} window {list(A.shape)}: kernel and plain differ at sweeps={s}")
            check(int(got[2].max()) <= s, f"{label}: {int(got[2].max())} sweeps past {s}")
            ran.append(f"{s}: {int(got[2].min())}-{int(got[2].max())}")
        print(f"{label} window {list(A.shape)}: kernel bit-equal to its plain version "
              f"at sweeps {ROUTE_SWEEPS}; sweeps run {', '.join(ran)}", flush=True)


def phase_routes(jc, grams):
    """``eigh_dc``'s routes beyond its defaults (:data:`ROUTES`) on the
    deflated Grams ``grams`` (``{"small": 1152², "large": 4608²}``): launches,
    the guarded result against float64, the raw (``guard=None``) violations
    and the trip flag, the time beside the default route's, and the window
    batches through the kernel and its plain version.  Returns ``(launches
    per route, the kernels-line totals per route)``."""
    import torch

    from vivit_tpu_torch import eigdc

    refs = {k: torch.linalg.eigvalsh(G.double()) for k, G in grams.items()}
    launches, windows = {}, {}

    def quiet(fn):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the trip is read from info
            return fn()

    for name, size, kw, modes in ROUTES:
        G, ref = grams[size], refs[size]
        n = G.shape[0]
        for vectors, expect in modes.items():
            label = f"eigh_dc {name} {n}² {'eigenpairs' if vectors else 'eigenvalues'}"

            def solve(**extra):
                return eigdc.eigh_dc(G, eigenvectors=vectors, **kw, **extra)

            quiet(lambda: solve(return_info=True))  # the first call per key captures
            ((ev, V, info), batches), count = launches_of(
                jc, lambda: quiet(lambda: recording_eigh(lambda: solve(return_info=True))))
            tripped = bool(info["tripped"])
            check(count == expect, f"{label}: {count} Jacobi launches, expected {expect}")
            line = check_route_result(label, G, ref, ev, V)
            raw_ratio, raw_bad = spectrum_ratio(quiet(lambda: solve(guard=None))[0], ref)
            if name == "forced trip":
                check(tripped, f"{label}: the guard did not trip")
            t, t_default = turn_times([
                lambda: quiet(solve),
                lambda: quiet(lambda: eigdc.eigh_dc(G, eigenvectors=vectors))])
            print(f"{label}: Jacobi launches {count}; guard tripped {tripped} (bound "
                  f"{float(info['bound']):.2e}, orth {float(info['orth']):.2e}); guarded "
                  f"result vs float64 {line}; raw (guard=None) {raw_bad}/{n} violations, "
                  f"max err/tol {raw_ratio:.3f}; {spread(t)} against the default route's "
                  f"{spread(t_default)} (CUDA events, median [min-max] of 5 calls each, "
                  "in turns)", flush=True)
            large = size == "large"
            totals = time_windows(jc, batches, label, reps=5 if large else 30,
                                  calls=1 if large else 10)
            check(totals["max_abs_err"] == 0.0,
                  f"{label}: kernel and plain differ by {totals['max_abs_err']:.2e}")
            check_route_sweeps(jc, batches, label)
            launches[label], windows[label] = count, totals
    return launches, windows


# the runtime calls that launch device work outside a CUDA graph
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaMemcpyAsync", "cudaMemsetAsync")
# launches outside the graphs that a replayed call may add to its eager
# steps' own (the vendor solves, LOBPCG's call): the input copies, each
# generator's seed and offset per graph, the steps' output copies, the output
# clones, the guards' verdict and, in the classes, the host criterion's copies
OUTSIDE_BAR = 100


def launch_profile(fn):
    """``fn`` once under ``torch.profiler``: ``{"wall", "busy"}`` in ms (host
    clock, device time summed over kernels, copies and fills), ``"device"``
    (their count), ``"jacobi"`` and ``"leaf"`` (the window and the leaf
    kernel's executions),
    ``"outside"`` (runtime launch calls outside any graph, :data:`LAUNCH_APIS`)
    and ``"graphs"`` (``cudaGraphLaunch`` calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    host = {e.key: e.count for e in events if e.device_type == DeviceType.CPU}
    return {"wall": wall, "busy": sum(e.self_device_time_total for e in device) / 1e3,
            "device": sum(e.count for e in device),
            "jacobi": sum(e.count for e in device if "jacobi_kernel" in e.key),
            "leaf": sum(e.count for e in device if "leaf_eigh_kernel" in e.key),
            "outside": sum(host.get(name, 0) for name in LAUNCH_APIS),
            "graphs": host.get("cudaGraphLaunch", 0)}


@contextmanager
def eager_body():
    """Inside the block, eigdc's chain-path solves run the eager body."""
    from vivit_tpu_torch import eigdc

    captured = eigdc._solve_captured
    eigdc._solve_captured = eigdc._solve_eager
    try:
        yield
    finally:
        eigdc._solve_captured = captured


def flat_tensors(out):
    """The tensors of a nested result, in order."""
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in flat_tensors(x)]
    return []


def cache_memory():
    """``(bytes of the cached graphs' memory pools or None, bytes of the
    entries' static buffers outside them)``."""
    from vivit_tpu_torch.utils import graphs

    buffers = sum(t.untyped_storage().nbytes() for e in graphs.entries().values()
                  for t in (*e.inputs, *(u for st in e.steps for u in flat_tensors(st.out))))
    return total(pool_sizes().values()), buffers


def total(sizes):
    """The sum of byte counts, ``None`` if one of them is unknown."""
    sizes = list(sizes)
    return None if None in sizes else sum(sizes)


def gb(x):
    return "not measured" if x is None else f"{x / 1e9:.3f} GB"


def phase_graphs(jc):
    """The captured execution of the chain path (phase 15): for the N=128
    headline Gram (eigenvalues) and ``eigh_topk``'s deflated Gram
    (eigenpairs), the capture (time, graphs, vendor steps and their shapes,
    Jacobi launches per graph), the replay against the eager body with the
    same key (bit-equal), launches outside graphs beside the vendor steps'
    own and the eager solve's (torch.profiler), the Jacobi kernel's
    executions in the trace against the counter, busy shares; the forced
    trip under replay in both modes; the five entries' call times with
    their bodies eager and their solves replayed (as before phase 16)
    against no graphs at all, in turns, bit-equal; the cache's memory; and the
    replay-against-eager tally of every solve :func:`recording_eigh` saw."""
    import torch

    import vivit_tpu_torch as vtt
    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch.kernels.jacobi_leaf_cuda import LEAF_MAX_M
    from vivit_tpu_torch.precision import _PRECISIONS, full_f32
    from vivit_tpu_torch.structured import gram_matrix_mixed
    from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt
    from vivit_tpu_torch.utils import graphs

    model = port_model()
    X, y = port_batch(N)
    loss = vtt.CrossEntropyLoss("mean")
    with full_f32():
        headline = gram_matrix_mixed(tapped_ggn_sqrt_vt(model, loss, X, y, deflate_ce_null=True),
                                     generic_precision=_PRECISIONS["bf16"])
    deflated = deflated_gram(model, loss, X, y)[2]
    release_graphs("phase 15")
    # (window, leaf) kernel launches: eigenvalues mode's leaves [16,150,150]
    # and bottom block [1,96,96]; eigenvector mode's leaves [14,150,150]
    for name, G, vectors, expect, expect_leaf in (
            ("headline solve", headline, False, 2, 2),
            ("eigenpair solve", deflated, True, 6, 1)):
        label = f"graphs: {name} {G.shape[0]}² ({'eigenpairs' if vectors else 'eigenvalues'})"

        def solve():
            with full_f32():
                return eigdc.eigh_dc(G, eigenvectors=vectors, return_info=True)

        before = set(graphs.entries())
        first, t_first = cuda_once(solve)
        (entry,) = [e for k, e in graphs.entries().items() if k not in before]
        steps = [f"{list(st.args[0].shape)}" for st in entry.steps]
        print(f"{label}: first call {t_first:.3f} ms (capture {entry.capture_s * 1e3:.3f} ms "
              f"host clock, warm-up included): {len(entry.graphs)} graphs, (window, leaf, token) "
              f"kernel launches captured per graph {entry.launches}, {len(steps)} vendor "
              f"steps between them {steps}", flush=True)
        check(all(st.fn is torch.linalg.eigh for st in entry.steps),
              f"{label}: a step other than the vendor eigh")
        check(all(st.args[0].shape[-1] > LEAF_MAX_M for st in entry.steps),
              f"{label}: a vendor step at m <= {LEAF_MAX_M}: {steps}")
        if not vectors:
            check(not entry.steps and len(entry.graphs) == 1,
                  f"{label}: {len(steps)} eager steps and {len(entry.graphs)} graphs, "
                  "expected none and one")
        out, (count, leaf) = counts_of(solve)
        check(count == expect, f"{label}: {count} Jacobi launches under replay, expected {expect}")
        check(leaf == expect_leaf,
              f"{label}: {leaf} leaf-kernel launches under replay, expected {expect_leaf}")
        check(not bool(out[2]["tripped"]), f"{label}: the guard tripped")
        with eager_body():
            ref = solve()
        pairs = list(zip(flat_tensors(out), flat_tensors(ref)))
        equal = all(torch.equal(a, b) for a, b in pairs)
        diff = max((a.double() - b.double()).abs().max().item() for a, b in pairs)
        print(f"{label}: replay vs eager body (same key): bit-equal {equal}, max|Δ| {diff:.3e}; "
              f"first call vs replay bit-equal "
              f"{equal_results(first, out)}",
              flush=True)
        if not equal:
            ratio = spectrum_ratio(out[0], torch.linalg.eigvalsh(G.double()))[0]
            print(f"{label}: the replay's eigenvalues vs float64 max err/tol {ratio:.3f}",
                  flush=True)
            check(ratio <= 1.0, f"{label}: the replay off float64 ({ratio:.2f} of the bar)")

        replay = launch_profile(solve)
        vendor = launch_profile(lambda: [st.fn(*st.args) for st in entry.steps])
        with eager_body():
            eager = launch_profile(solve)
        extra = replay["outside"] - vendor["outside"]
        print(f"{label} under torch.profiler: replay {replay['wall']:.3f} ms, busy "
              f"{replay['busy']:.3f} ms = {replay['busy'] / replay['wall']:.1%}, launches outside "
              f"graphs {replay['outside']} (the vendor steps' own {vendor['outside']}, the rest "
              f"{extra}, bar {OUTSIDE_BAR}), graph launches {replay['graphs']}, device operations "
              f"{replay['device']}, Jacobi kernel executions {replay['jacobi']} (counter "
              f"{count}), leaf kernel executions {replay['leaf']} (counter {leaf}); eager "
              f"body {eager['wall']:.3f} ms, busy {eager['busy']:.3f} ms = "
              f"{eager['busy'] / eager['wall']:.1%}, launches {eager['outside']}, device "
              f"operations {eager['device']}, Jacobi kernel executions {eager['jacobi']}",
              flush=True)
        check(extra <= OUTSIDE_BAR, f"{label}: {extra} launches outside graphs beyond the vendor's")
        check(replay["jacobi"] == count,
              f"{label}: the trace shows {replay['jacobi']} Jacobi kernels, the counter {count}")
        check(replay["leaf"] == leaf,
              f"{label}: the trace shows {replay['leaf']} leaf kernels, the counter {leaf}")

    # the forced trip of phase 14 under replay: it trips, warns, and the
    # result is the vendor's on the same matrix
    forced = next(kw for name, _, kw, _ in ROUTES if name == "forced trip")
    for vectors, expect in ((False, 2), (True, 6)):
        label = f"graphs: forced trip {deflated.shape[0]}² " \
                f"({'eigenpairs' if vectors else 'eigenvalues'})"

        def solve():
            with full_f32():
                return eigdc.eigh_dc(deflated, eigenvectors=vectors, return_info=True, **forced)

        before = len(graphs.entries())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            solve()  # the capture
        check(len(graphs.entries()) == before + 1, f"{label}: no new cache entry")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            (ev, V, info), count = launches_of(jc, solve)
        trips = [w for w in caught if "guard tripped" in str(w.message)]
        with full_f32():
            H = 0.5 * (deflated + deflated.T)
            want = torch.linalg.eigh(H) if vectors else (torch.linalg.eigvalsh(H), None)
        same = torch.equal(ev, want[0]) and (V is None or torch.equal(V, want[1]))
        print(f"{label}: under replay Jacobi launches {count}, tripped {bool(info['tripped'])} "
              f"(bound {float(info['bound']):.2e}, orth {float(info['orth']):.2e}), "
              f"{len(trips)} warning, result equal to the vendor's {same}", flush=True)
        check(count == expect, f"{label}: {count} Jacobi launches, expected {expect}")
        check(bool(info["tripped"]) and len(trips) == 1, f"{label}: the guard did not trip")
        check(same, f"{label}: the fallback's result is not the vendor's")

    # the entries' call times, replay against eager body in turns
    model_fn, params = generic_model()
    settings = dict(eig_backend="dc", **HEADLINE)
    eigvalsh = vtt.EigvalshComputation(model_fn, loss, **settings)
    eigh = vtt.EighComputation(model_fn, loss, **settings)
    groups = [{"params": list(params), "criterion": vtt.keep_top_k(TOP_K)}]
    entries = {
        f"eigvalsh_structured N={N} (headline)": lambda: vtt.eigvalsh_structured(
            model, loss, X, y, eig_backend="dc", **HEADLINE),
        f"eigh_topk N={N}": lambda: vtt.eigh_topk(model, loss, X, y, TOP_K, solver="dc",
                                                  **HEADLINE),
        f"newton_step_structured N={N} (dc)": lambda: vtt.newton_step_structured(
            model, loss, X, y, TOP_K, damping=1.0, solver="dc", **HEADLINE),
        f"EigvalshComputation N={N}": lambda: eigvalsh.compute(X, y, params=params),
        f"EighComputation N={N}": lambda: eigh.compute(X, y, groups, params=params),
    }

    # the entry points' bodies run eagerly here, as before phase 16's
    # captured calls: only their chain-path solves replay
    def solve_graphs(call):
        def run():
            with eager_entries():
                return call()
        return run

    def eagerly(call):
        def run():
            with eager_entries(), eager_body():
                return call()
        return run

    for label, call in entries.items():
        call = solve_graphs(call)
        with deterministic_cudnn():  # the V-transforms' weight gradients
            out = untripped(call, label)
            ref = eagerly(call)()
        equal = equal_results(out, ref)
        check(equal, f"{label}: the replayed call differs from the eager body's")
        t_replay, t_eager = turn_times([call, eagerly(call)])
        print(f"graphs: {label} (the solve replayed, the rest eager): replay "
              f"{spread(t_replay)}, eager body {spread(t_eager)} (CUDA events around one "
              "call, median [min-max] of 5, in turns), replay/eager "
              f"{np.median(t_replay) / np.median(t_eager):.3f}; results bit-equal {equal}",
              flush=True)
    headline_call = solve_graphs(entries[f"eigvalsh_structured N={N} (headline)"])
    replay, eager = launch_profile(headline_call), launch_profile(eagerly(headline_call))
    print(f"graphs: eigvalsh_structured N={N} (headline) under torch.profiler: replay "
          f"{replay['wall']:.3f} ms, busy {replay['busy'] / replay['wall']:.1%}, launches outside "
          f"graphs {replay['outside']}, graph launches {replay['graphs']}, device operations "
          f"{replay['device']}; eager body {eager['wall']:.3f} ms, busy "
          f"{eager['busy'] / eager['wall']:.1%}, launches {eager['outside']}, device operations "
          f"{eager['device']}", flush=True)

    pool_bytes, buffers = cache_memory()
    print(f"graphs: the cache holds {len(graphs.entries())} entries, their memory pools "
          f"{gb(pool_bytes)}, static buffers outside them {gb(buffers)}", flush=True)
    graphs.clear()
    print(f"graphs: after clear(): {len(graphs.entries())} entries, memory pools "
          f"{gb(cache_memory()[0])}", flush=True)

    check(REPLAYS, "no chain-path solve was held against the eager body")
    unequal = [r for r in REPLAYS if not r[2]]
    print(f"graphs: {len(REPLAYS)} chain-path solves of the phases above replayed against the "
          f"eager body with the same key: {len(REPLAYS) - len(unequal)} bit-equal, max|Δ| "
          f"{max((r[3] for r in REPLAYS), default=0.0):.3e}" + "".join(
              f"; {n}² {mode} unequal, max|Δ| {d:.3e}, float64 err/tol {q:.3f}"
              for n, mode, _, d, q in unequal), flush=True)


def key_name(key):
    """A short name of a graph cache key: the entry point's, or the solve's
    size and mode."""
    if key[0] == "eigh_dc":
        return f"eigh_dc {key[1]}² {'eigenpairs' if key[3] else 'eigenvalues'}"
    return key[0][0]


def pool_sizes():
    """``{key: bytes of its memory pool}`` of every cached entry (``None``
    where the snapshot names no pools)."""
    import torch

    from vivit_tpu_torch.utils import graphs

    segments = torch.cuda.memory_snapshot()
    known = all("segment_pool_id" in seg for seg in segments)
    return {key: (sum(seg["total_size"] for seg in segments
                      if tuple(seg["segment_pool_id"]) == tuple(e.pool)) if known else None)
            for key, e in graphs.entries().items()}


# (key name, pool bytes) of every key that release_graphs released
RELEASED = []


def release_graphs(label):
    """Print each cached key's pool bytes and their sum, then drop them
    (``graphs.clear()``)."""
    from vivit_tpu_torch.utils import graphs

    sizes = [(key_name(key), b) for key, b in pool_sizes().items()]
    RELEASED.extend(sizes)
    print(f"graphs before {label}: {len(sizes)} keys, memory pools "
          + ", ".join(f"{name} {gb(b)}" for name, b in sizes)
          + f"; sum {gb(total(b for _, b in sizes))}; clear()", flush=True)
    graphs.clear()


def sgd_(model_fn, params, loss, X, y, lr=0.1):
    """One in-place SGD step on the tensors of ``params`` (the module's own
    storage for a module)."""
    import torch

    grads = torch.func.grad(lambda p: loss(model_fn(p, X), y))(params)
    with torch.no_grad():
        for name, p in params.items():
            p.sub_(lr * grads[name])


# (window, leaf) kernel launches of one N=128 call by the mode of its chain
# solve (1152²): eigenvalues, eigenpairs, none (LOBPCG)
EIGVALS, EIGPAIRS, NO_DC = (2, 2), (6, 1), (0, 0)


def entry_cases():
    """Phase 16's entry points: ``(label, (window, leaf) kernel launches,
    forced trip possible, build)``; ``build()`` gives ``(call(X, y), model_fn, params,
    replace(), module form)``, ``params`` the tensors the calls read (a
    module's own storage), ``replace()`` swapping one of them for a new
    tensor (a module's: a copy; a model function's: half of it)."""
    import vivit_tpu_torch as vtt
    from vivit_tpu_torch.engines import forward_fn, module_params

    loss = vtt.CrossEntropyLoss("mean")
    settings = dict(eig_backend="dc", **HEADLINE)

    # a module's replaced tensor stays alive, or a later copy could take its
    # address (and with it its key: the graphs read the tensor at that address)
    replaced = []

    def module_form(make):
        def build():
            model = port_model()
            last = list(model.parameters())[-1]

            def replace():
                replaced.append(last.data)
                last.data = last.data.clone()
            return make(model, {}), forward_fn(model), module_params(model), replace, True
        return build

    def function_form(make):
        def build():
            model_fn, params = generic_model()
            name = list(params)[-1]

            def replace():
                params[name] = params[name] * 0.5
            return make(model_fn, {"params": params}), model_fn, params, replace, False
        return build

    def topk(fn, **kw):
        return module_form(lambda m, p: lambda X, y: fn(m, loss, X, y, TOP_K, **kw, **HEADLINE))

    def comp(cls, criterion, form, **extra):
        groups = lambda names: [{"params": names, "criterion": vtt.keep_top_k(TOP_K), **extra}]

        def make(m, p):
            c = cls(m, loss, **settings)
            names = list(p["params"]) if p else [n for n, _ in m.named_parameters()]
            args = (groups(names),) if criterion else ()
            return lambda X, y: c.compute(X, y, *args, **p)
        return (module_form if form == "module" else function_form)(make)

    damping = vtt.constant_damping(1.0)
    cases = [
        (f"eigvalsh_structured N={N} (headline)", EIGVALS, True, module_form(
            lambda m, p: lambda X, y: vtt.eigvalsh_structured(
                m, loss, X, y, eig_backend="dc", return_eig_info=True, **HEADLINE))),
        (f"eigvalsh N={N} (model function)", EIGVALS, True, function_form(
            lambda m, p: lambda X, y: vtt.eigvalsh(m, loss, X, y, **p, **settings))),
        (f"eigh_topk N={N}, k={TOP_K} (dc)", EIGPAIRS, True, topk(vtt.eigh_topk, solver="dc")),
        (f"directional_derivatives_topk N={N}, k={TOP_K} (dc)", EIGPAIRS, True,
         topk(vtt.directional_derivatives_topk, solver="dc")),
        (f"newton_step_structured N={N} (dc)", EIGPAIRS, True,
         topk(vtt.newton_step_structured, damping=1.0, solver="dc")),
        (f"newton_step_structured N={N} (lobpcg)", NO_DC, False,
         topk(vtt.newton_step_structured, damping=1.0, solver="lobpcg")),
    ]
    for form in ("model function", "module"):
        short = "module" if form == "module" else "function"
        cases += [
            (f"EigvalshComputation N={N} ({form})", EIGVALS, True,
             comp(vtt.EigvalshComputation, False, short)),
            (f"EighComputation N={N} ({form}, keep_top_k({TOP_K}))", EIGPAIRS, True,
             comp(vtt.EighComputation, True, short)),
            (f"DirectionalDerivativesComputation N={N} ({form}, keep_top_k({TOP_K}))", EIGPAIRS, True,
             comp(vtt.DirectionalDerivativesComputation, True, short)),
            (f"DirectionalDampedNewtonComputation N={N} ({form}, keep_top_k({TOP_K}))", EIGPAIRS, True,
             comp(vtt.DirectionalDampedNewtonComputation, True, short, damping=damping)),
        ]
    return loss, cases


def entry_keys():
    """The graph cache's keys of entry-point programs (not of the
    chain-path solves that an eager body replays on its own)."""
    from vivit_tpu_torch.utils import graphs

    return {k for k in graphs.entries() if k[0] != "eigh_dc"}


@contextmanager
def handed_back():
    """Inside the block, a captured entry point's program launches nothing:
    ``graphs.stage`` hands back the outputs its entry holds."""
    from vivit_tpu_torch.utils import graphs

    stage = graphs.stage
    graphs.stage = lambda key, body, X, y, params, route: (graphs.entries()[key].outputs, True)
    try:
        yield
    finally:
        graphs.stage = stage


def equal_results(out, ref):
    import torch

    a, b = flat_tensors(out), flat_tensors(ref)
    return len(a) == len(b) > 0 and all(torch.equal(x, z) for x, z in zip(a, b))


def phase_entry_graphs(jc):
    """The entry points' captured execution (phase 16), on full-width 3c3d
    at N=128 with the headline settings, under deterministic cuDNN: for each
    entry point of :func:`entry_cases` the capture (time, graphs, eager
    steps and their shapes, pool bytes), the replay bit-equal to the eager
    body, the replay after an in-place SGD step and on a new batch equal to
    a fresh eager call (same key), a replaced parameter tensor (a model
    function's: the same key, copied in; a module's: a new key, the stale
    one dropped) giving a fresh eager call's result, launches outside the
    graphs beyond the vendor and LOBPCG steps' own and a class's eager rest
    after its program (at most :data:`OUTSIDE_BAR`), the Jacobi kernel's
    executions in the trace equal to the counter, the busy share, the
    replay against the eager body and against solve-only graphs in turns,
    and a guard trip under replay forced by a zero threshold (one warning,
    the vendor's result); then the entry replays :func:`recording_eigh`
    held against their eager bodies in phases 3-15, within
    :data:`ENTRY_BAR`."""
    import functools

    import torch

    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch.kernels.jacobi_leaf_cuda import LEAF_MAX_M
    from vivit_tpu_torch.utils import graphs

    X, y = port_batch(N)
    X2, y2 = port_batch(N, seed=1)
    loss, cases = entry_cases()
    rows = []
    release_graphs("phase 16")
    with deterministic_cudnn():
        for label, (expect, expect_leaf), trips, build in cases:
            call, model_fn, params, replace, module = build()
            label = f"entry graphs: {label}"

            def eager_call(X_=X, y_=y):
                with eager_entries():
                    return call(X_, y_)

            def fully_eager():
                with eager_entries(), eager_body():
                    return call(X, y)

            # the capture
            before = entry_keys()
            _, t_first = cuda_once(lambda: untripped(lambda: call(X, y), label))
            keys = [k for k in graphs.entries() if k in entry_keys() - before]
            check(keys, f"{label}: the first call captured nothing")
            entries = [graphs.entries()[k] for k in keys]
            steps = [f"{st.fn.__name__}{list(st.args[0].shape)}" for e in entries
                     for st in e.steps]
            # the eager steps: none in eigenvalues mode, else the vendor's
            # blocks above the leaf kernel's m (and LOBPCG's call)
            vendor = [st for e in entries for st in e.steps if st.fn is torch.linalg.eigh]
            check(all(st.args[0].shape[-1] > LEAF_MAX_M for st in vendor),
                  f"{label}: a vendor step at m <= {LEAF_MAX_M}: {steps}")
            if (expect, expect_leaf) == EIGVALS:
                check(not steps, f"{label}: eager steps {steps} in an eigenvalues-mode call")
            # the replay against the eager body
            out, (count, leaf) = counts_of(lambda: untripped(lambda: call(X, y), label))
            check(entry_keys() == before | set(keys), f"{label}: the replay captured")
            check(count == expect, f"{label}: {count} Jacobi launches under replay, "
                  f"expected {expect}")
            check(leaf == expect_leaf, f"{label}: {leaf} leaf-kernel launches under replay, "
                  f"expected {expect_leaf}")
            with uncounted():
                ref = untripped(eager_call, label)
            check(equal_results(out, ref), f"{label}: the replay differs from the eager body")
            # an in-place SGD step: the same key, the new parameters read in place
            sgd_(model_fn, params, loss, X, y)
            stepped = call(X, y)
            with uncounted():
                ref = eager_call()
            check(entry_keys() == before | set(keys),
                  f"{label}: an in-place update captured anew")
            check(not equal_results(stepped, out), f"{label}: the step changed nothing")
            check(equal_results(stepped, ref), f"{label}: after an in-place SGD step the "
                  "replay differs from a fresh eager call")
            # a new batch: the same key
            other = call(X2, y2)
            with uncounted():
                ref = eager_call(X2, y2)
            check(entry_keys() == before | set(keys), f"{label}: a new batch captured")
            check(equal_results(other, ref), f"{label}: on a new batch the replay differs "
                  "from the eager call")
            # launches outside the graphs, the trace's Jacobi executions, busy share
            replay = launch_profile(lambda: call(X, y))
            own = launch_profile(lambda: [st.fn(*st.args) for e in entries for st in e.steps])
            # a class's eager rest after its program (the host criteria and
            # what reads the kept indices), counted apart: stage hands back
            # the entry's outputs and launches nothing
            rest = {"outside": 0}
            if "Computation" in label:
                with handed_back():
                    rest = launch_profile(lambda: call(X, y))
            extra = replay["outside"] - own["outside"] - rest["outside"]
            check(extra <= OUTSIDE_BAR, f"{label}: {extra} launches outside graphs beyond "
                  "the vendor and LOBPCG steps' and the class's eager rest")
            check(replay["jacobi"] == count, f"{label}: the trace shows {replay['jacobi']} "
                  f"Jacobi kernels, the counter {count}")
            check(replay["leaf"] == leaf, f"{label}: the trace shows {replay['leaf']} "
                  f"leaf kernels, the counter {leaf}")
            solve_only = launch_profile(eager_call)
            # times in turns: the replay, solve-only graphs (the entry eager,
            # its chain-path solve replayed), no graphs at all
            t_replay, t_solve, t_eager = turn_times(
                [lambda: call(X, y), eager_call, fully_eager])
            sizes = pool_sizes()
            pools = [sizes[k] for k in keys]
            # a replaced parameter tensor: a module's gives a new key, which
            # drops the stale one; a model function's is copied in (the same key)
            replace()
            fresh = call(X, y)
            now = entry_keys() - before
            if module:
                check(now and not now & set(keys), f"{label}: a replaced parameter tensor "
                      "did not capture anew in place of the stale key")
            else:
                check(now == set(keys), f"{label}: a replaced parameter tensor captured anew")
            check(equal_results(fresh, untripped(eager_call, label)),
                  f"{label}: after a replaced tensor the result differs from the eager call's")
            # a forced guard trip under replay (a new capture, the entries
            # dropped): a zero threshold trips every solve's guard
            trip_line = "no dc solve, no guard"
            if trips:
                graphs.clear()
                solver = eigdc.eigh_dc
                eigdc.eigh_dc = functools.partial(solver, guard=0.0)
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        call(X, y)  # the capture; its guard trips too
                        want = eager_call()
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        got = call(X, y)
                finally:
                    eigdc.eigh_dc = solver
                warned = [w for w in caught if "guard tripped" in str(w.message)]
                same = equal_results(got, want)
                check(len(warned) == 1, f"{label}: the forced trip warned {len(warned)} times")
                check(same, f"{label}: the forced trip's result is not the eager call's")
                trip_line = (f"forced trip under replay: {len(warned)} warning, result equal "
                             f"to the eager call's (the vendor's solve) {same}")
            rows.append((label, np.median(t_replay), np.median(t_solve), np.median(t_eager),
                         extra, replay["busy"] / replay["wall"], total(pools)))
            print(f"{label}: first call {t_first:.3f} ms (capture "
                  + " + ".join(f"{e.capture_s * 1e3:.3f}" for e in entries)
                  + f" ms host clock, warm-up included; {len(keys)} programs, "
                  f"{sum(len(e.graphs) for e in entries)} graphs, (window, leaf, token) kernel "
                  f"launches captured per graph {[e.launches for e in entries]}, eager steps "
                  f"{steps}, pools "
                  + ", ".join(gb(b) for b in pools) + "); the replay bit-equal to the eager "
                  "body, after an in-place SGD step, on a new batch and after a replaced "
                  "parameter tensor (" + ("captured anew, the stale key dropped" if module
                                          else "copied in, the same key")
                  + ") equal to a fresh eager call; " + trip_line, flush=True)
            print(f"{label}: under torch.profiler the replay {replay['wall']:.3f} ms, busy "
                  f"{replay['busy']:.3f} ms = {replay['busy'] / replay['wall']:.1%}, launches "
                  f"outside graphs {replay['outside']} (the eager steps' own {own['outside']}, "
                  f"the class's eager rest after its program {rest['outside']}, the rest "
                  f"{extra}, bar {OUTSIDE_BAR}), graph launches {replay['graphs']}, "
                  f"Jacobi kernel executions {replay['jacobi']} (counter {count}), leaf kernel "
                  f"executions {replay['leaf']} (counter {leaf}); solve-only "
                  f"graphs {solve_only['wall']:.3f} ms, busy "
                  f"{solve_only['busy'] / solve_only['wall']:.1%}, launches "
                  f"{solve_only['outside']}; times (CUDA events around one call, median "
                  f"[min-max] of 5, in turns): replay {spread(t_replay)}, solve-only graphs "
                  f"{spread(t_solve)}, no graphs {spread(t_eager)}; replay/solve-only "
                  f"{np.median(t_replay) / np.median(t_solve):.3f}, replay/no graphs "
                  f"{np.median(t_replay) / np.median(t_eager):.3f}", flush=True)
            release_graphs(label)
    print("entry graphs, one row per entry point (ms: median of 5 in turns, under "
          "deterministic cuDNN): replay | solve-only graphs | no graphs | launches outside "
          "graphs beyond the steps' and a class's eager rest | busy | pool bytes", flush=True)
    for label, *r in rows:
        print(f"  {label[len('entry graphs: '):]}: {r[0]:.3f} | {r[1]:.3f} | {r[2]:.3f} | "
              f"{r[3]} | {r[4]:.1%} | {gb(r[5])}", flush=True)
    print(f"graphs: {len(RELEASED)} keys released over the run, their memory pools summed "
          f"{gb(total(b for _, b in RELEASED))}", flush=True)
    check(ENTRY_REPLAYS, "no entry replay was held against its eager body")
    unequal = [d for equal, d in ENTRY_REPLAYS if not equal]
    print(f"entry graphs: {len(ENTRY_REPLAYS)} entry-point calls of phases 3-15 replayed "
          f"against their eager bodies: {len(ENTRY_REPLAYS) - len(unequal)} bit-equal; the "
          f"rest (cuDNN's default algorithms) max|Δ|/max|result| "
          f"{max(unequal, default=0.0):.3e}, bar {ENTRY_BAR:.3e}", flush=True)
    check(max(unequal, default=0.0) <= ENTRY_BAR,
          "an entry replay differs from its eager body beyond ENTRY_BAR")


def main():
    import torch

    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from vivit_tpu_torch.kernels import jacobi_cuda as jc
    from vivit_tpu_torch.kernels import toolchain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = dict(zip(KERNEL_SOURCES, pool.map(toolchain.build, KERNEL_SOURCES)))
    print(f"kernel builds (nvcc, sm_90a, one process per source, started together): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, (_, build_s, log) in builds.items():
        print(f"  csrc/{name}.cu: {build_s:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}", flush=True)

    try:
        max_err, timing = phase_kernel(jc)
        phase_shape_sweep(jc)
        phase_leaf_sweep()
        phase_direct_solves()
        launches = phase_main_path(jc)
        model = port_model()
        small, evecs_launches, (gram_d, _, V_d), batches = phase_eigenpairs(jc, model, N, 6)
        time_windows(jc, batches, f"eigh_topk N={N}")
        refine_launches = phase_refine(jc, gram_d, V_d)
        release_graphs("the N=512 phases")
        spectrum_launches, spectrum, spectrum_win = phase_spectrum_large(jc, model, 4)
        large, large_launches, (gram_large, _, _), batches = phase_eigenpairs(
            jc, model, N_LARGE, 6)
        large_win = time_windows(jc, batches, f"eigh_topk N={N_LARGE}", reps=5, calls=1)
        phase_times(model, small, large, spectrum)
        newton_launches = phase_newton(jc, model)
        del model
        generic_launches = phase_generic(jc)
        streamed_launches, times, streamed_win = phase_streamed(jc)
        times.update(phase_extensions())
        times.update(phase_matrix_free())
        dp_launches, dp_times = phase_data_parallel(jc)
        times.update(dp_times)
        route_launches, route_win = phase_routes(jc, {"small": gram_d,
                                                      "large": gram_large})
        phase_graphs(jc)
        phase_entry_graphs(jc)
        release_graphs("the three-pass phase")
        three_pass_rows = phase_three_pass(port_model())
        token_rows = phase_token_expand()
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
        **generic_launches, **streamed_launches, **dp_launches, **route_launches}),
        flush=True)

    t = [timing[s] for s in HEADLINE_SHAPES]
    kernel = {"name": "jacobi_eigh", "route": "cuda",
              "source": "vivit_tpu_torch/csrc/jacobi.cu",
              "replaces": "vivit_tpu/kernels/jacobi_pallas.py:178"}
    # times: the sums over the window launches of one solve of the path;
    # the bound counts the sweeps each matrix ran
    kernels = [{
        **kernel,
        "path": f"eigvalsh_structured N={N}",
        "launches": launches,
        "max_abs_err": max_err,
        # the most sweeps a matrix of the two window batches ran
        "sweeps": max(x[5] for x in t),
        "ms": sum(x[0] for x in t),
        "plain_ms": sum(x[1] for x in t),
        "bound_ms": sum(x[3] for x in t),
        "bound_by": t[0][4],
        "library_ms": sum(x[2] for x in t),
    }] + [{**kernel, "path": path, **win, "launches": n_launches}
          for path, win, n_launches in (
              (f"eigvalsh_structured N={N_LARGE}", spectrum_win, spectrum_launches),
              (f"eigh_topk N={N_LARGE}", large_win, large_launches),
              (f"eigvalsh_streamed N={N_LARGE}", streamed_win,
               streamed_launches[f"eigvalsh_streamed N={N_LARGE}"]))] + [
        {**kernel, "path": path, **win, "launches": route_launches[path]}
        for path, win in route_win.items()]
    print("leaf-kernel launches per path: " + json.dumps(
        {path: row["launches"] for path, row in LEAF_ROWS.items()}), flush=True)
    leaf = {"name": "jacobi_leaf_eigh", "route": "cuda",
            "source": "vivit_tpu_torch/csrc/jacobi_leaf.cu",
            "replaces": "vivit_tpu/eigdc.py:360"}
    # times: the sums over the path's leaf and edge batches of one solve
    kernels += [{**leaf, "path": path, **row} for path, row in LEAF_ROWS.items()]
    # times: one chunk; a layer's Gram launches once a chunk and range of
    # positions (``launches``: one chunk's)
    kernels += [{"name": "token_expand_kernel", "route": "cuda",
                 "source": "vivit_tpu_torch/csrc/token_expand.cu", "replaces": None, **row}
                for row in token_rows]
    # the strip path's launches over one solve, then one call (time, bound)
    # of each of the strip basis's shapes
    kernels += [{"name": "three_pass_kernel", "route": "cuda",
                 "source": "vivit_tpu_torch/csrc/three_pass.cu", "replaces": None, **row}
                for row in three_pass_rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"command time: {time.perf_counter() - started:.1f} s (from the start of main)",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
