#!/usr/bin/env python3
"""The measurements behind ``precision.matmul``'s three-pass TF32 product,
on one CUDA card.

    PYTHONPATH=. python3 tools/torch_three_pass.py
    PYTHONPATH=<checkout> python3 tools/torch_three_pass.py --dump FILE
    python3 tools/torch_three_pass.py --compare FILE FILE

Without options:

1. ``chip_smoke.py``'s phase 17: the kernel (``csrc/three_pass.cu``) on
   one strip-path solve, then against the f32 product, its plain version,
   the cuBLAS passes it replaced and float64 at the strip basis's shapes,
   the square sweep
   against the f32 product, and the N=128 calls that reach no ``"high"``
   product.
2. On the deflated N=512 Gram of CIFAR-10 3c3d (the smoke's weights and
   data, 4608²), one ``eigvalsh_dc`` call: the ``"high"`` products that
   engaged and declined, the kernel's launches (one an engaged product),
   how many engaged products take a transposed view (``Yᵀ Y``), and the
   share of the basis's product flops that engaged
   (``torch.utils.flop_counter`` over ``eigh_dc``'s basis; an engaged
   product counts once, not as its three passes).
3. The same solve with the three passes (``THREE_PASS_MIN`` as set), with
   the threshold at each of :data:`THRESHOLDS`, and with every product in
   f32 (the threshold out of reach), in turns: the call's time (host
   clock, synchronized), its peak of allocated memory, its worst error
   against float64 over the bars of the smoke (rtol 1e-4, atol
   5e-6·λmax) and the guard's verdict.

``--dump FILE`` saves the results of the default N=128 entries
(``eigvalsh_structured`` and ``eigh_topk`` with the smoke's headline
settings, deterministic cuDNN) for the package that ``PYTHONPATH`` names:
run it once on a checkout of the parent commit and once on this one, in
one call, then ``--compare`` holds the two bit for bit.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the thresholds timed beside the one set: the sizes of the strip basis's
# products at N=512 lie at 4608, 2448, 1300 and below
THRESHOLDS = (2049, 2449)


def n128_results():
    """The default N=128 entries' results under deterministic cuDNN."""
    import torch

    import vivit_tpu_torch as vtt
    from chip_smoke import HEADLINE, N, TOP_K, deterministic_cudnn, port_batch, port_model

    model, loss = port_model(), vtt.CrossEntropyLoss("mean")
    X, y = port_batch(N)
    with deterministic_cudnn():
        results = {
            "eigvalsh_structured": vtt.eigvalsh_structured(
                model, loss, X, y, eig_backend="dc", **HEADLINE),
            "eigh_topk": vtt.eigh_topk(model, loss, X, y, TOP_K, solver="dc", **HEADLINE),
        }
    torch.cuda.synchronize()
    out = {}

    def flatten(name, value):
        if isinstance(value, torch.Tensor):
            out[name] = value.detach().cpu()
        elif isinstance(value, dict):
            for k, v in value.items():
                flatten(f"{name}.{k}", v)
        else:
            for i, v in enumerate(value):
                flatten(f"{name}.{i}", v)

    for name, value in results.items():
        flatten(name, value)
    return out


def compare(a, b):
    import torch

    ra, rb = torch.load(a), torch.load(b)
    same = sorted(ra) == sorted(rb) and all(torch.equal(ra[k], rb[k]) for k in ra)
    for k in sorted(ra):
        d = (ra[k].double() - rb[k].double()).abs().max().item() if k in rb else float("nan")
        print(f"{k}: {tuple(ra[k].shape)}, max |difference| {d:.3e}", flush=True)
    print(f"N=128 results bit for bit equal: {same}", flush=True)
    return 0 if same else 1


def basis_share(H):
    """``(engaged, declined, kernel launches, engaged products whose ``a`` is
    a transposed view (``Yᵀ Y``; the wrapper copies it row-major), engaged
    share of the basis's product flops, the basis's product flops)`` of one
    ``eigvalsh_dc(H)`` call."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from vivit_tpu_torch import eigdc, precision
    from vivit_tpu_torch.kernels import three_pass

    counter = FlopCounterMode(display=False)
    # [engaged flops, what the counter gave the engaged products' passes,
    # engaged products of a transposed a]
    engaged = [0.0, 0.0, 0]
    mm, basis = eigdc._mm, eigdc._basis

    def counted(a, b, prec=None):
        before, passes = precision.THREE_PASS, counter.get_total_flops()
        out = mm(a, b, prec)
        if precision.THREE_PASS != before:
            batch = a.shape[0] if a.dim() == 3 else 1
            engaged[0] += 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]
            engaged[1] += counter.get_total_flops() - passes
            engaged[2] += a.stride(-1) != 1
        return out

    def root_counted(H, count, gen, depth, cfg):
        if depth:
            return basis(H, count, gen, depth, cfg)
        with counter:
            return basis(H, count, gen, depth, cfg)

    counts = (precision.THREE_PASS, precision.THREE_PASS_DECLINED, three_pass.LAUNCHES)
    eigdc._mm, eigdc._basis = counted, root_counted
    try:
        eigdc.eigvalsh_dc(H)
        torch.cuda.synchronize()
    finally:
        eigdc._mm, eigdc._basis = mm, basis
    # an engaged product counts once, whatever the counter made of its passes
    logical = counter.get_total_flops() - engaged[1] + engaged[0]
    return (precision.THREE_PASS - counts[0], precision.THREE_PASS_DECLINED - counts[1],
            three_pass.LAUNCHES - counts[2], engaged[2], engaged[0] / logical, logical)


def solve_in_turns(H, rounds=3):
    import torch

    from chip_smoke import ATOL, RTOL
    from vivit_tpu_torch import eigdc, precision

    ref = torch.linalg.eigvalsh(H.double())
    tol = ATOL * ref.abs().max() + RTOL * ref.abs()
    saved = precision.THREE_PASS_MIN
    arms = {"three passes": saved,
            **{f"three passes from {t}": t for t in THRESHOLDS if t != saved},
            "f32": 10 ** 9}
    rows = {label: [] for label in arms}
    try:
        for _ in range(rounds):
            for label, arm in arms.items():
                precision.THREE_PASS_MIN = arm
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                ev, info = eigdc.eigvalsh_dc(H, return_info=True)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                ratio = ((ev.double() - ref).abs() / tol).max().item()
                rows[label].append((ms, torch.cuda.max_memory_allocated() / 1e9, ratio,
                                    bool(info["tripped"]), float(info["bound"])))
    finally:
        precision.THREE_PASS_MIN = saved
    for label, runs in rows.items():
        ms = [r[0] for r in runs]
        print(f"eigvalsh_dc {tuple(H.shape)} {label}: {np.median(ms):.2f} ms median "
              f"[{min(ms):.2f}-{max(ms):.2f}]; peak allocated {runs[0][1]:.3f} GB; "
              f"max err/tol vs float64 {[round(r[2], 4) for r in runs]}; tripped "
              f"{[r[3] for r in runs]}, bound {[f'{r[4]:.2e}' for r in runs]}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dump", metavar="FILE")
    parser.add_argument("--compare", nargs=2, metavar="FILE")
    args = parser.parse_args()
    if args.compare:
        return compare(*args.compare)

    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_three_pass: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if args.dump:
        torch.save(n128_results(), args.dump)
        print(f"saved the N=128 results to {args.dump}", flush=True)
        return 0

    import vivit_tpu_torch as vtt
    from chip_smoke import N_LARGE, deflated_gram, phase_three_pass, port_batch, port_model

    model = port_model()
    phase_three_pass(model)
    from vivit_tpu_torch import precision

    X, y = port_batch(N_LARGE)
    _, _, H = deflated_gram(model, vtt.CrossEntropyLoss("mean"), X, y)
    del model, X, y
    engaged, declined, launches, transposed, share, logical = basis_share(H)
    print(f"eigvalsh_dc {tuple(H.shape)}: THREE_PASS_MIN {precision.THREE_PASS_MIN}, "
          f"{engaged} products engaged ({launches} kernel launches, {transposed} of a "
          f"transposed a, copied row-major), {declined} declined "
          f"(hit share {engaged / max(engaged + declined, 1):.4f}); the basis's products "
          f"{logical / 1e12:.3f} TFLOP, engaged {share:.4f} of them", flush=True)
    if launches != engaged:
        print(f"torch_three_pass: {launches} kernel launches for {engaged} engaged products",
              file=sys.stderr)
        return 1
    solve_in_turns(H)
    return 0


if __name__ == "__main__":
    sys.exit(main())
