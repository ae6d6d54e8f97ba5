"""Configuration sweep of the port's spectral D&C eigensolver on one NVIDIA card.

The card's counterpart of ``tools/sweep_eigdc.py``: its ``CONFIGS``, each run
by ``vivit_tpu_torch.eigdc.eigvalsh_dc`` with ``guard=None`` (raw: a
tripped guard would hide an accuracy regression behind the vendor solver's
answer) on the port's deflated Grams of full-width CIFAR-10 3c3d, built as
``chip_smoke.py`` builds them (``cnn3c3d_flax_params(seed=0)``, numpy
``default_rng(0)`` data, the bf16 Gram deflated at the Gram level): 1152² at
N=128 and 4608² at N=512.  For each configuration it prints the median and
spread of the CUDA-event times of ``--reps`` calls after a warm-up, the
Jacobi launches of one call, and the violations of float64's eigenvalue bar
(rtol 1e-4, atol 5e-6·λmax) with the largest err/tol.  Below the strip a
configuration's calls replay the CUDA graphs its first call captured.  It
measures and changes no default.  The card's name and power limit come
first.

Usage::

    PYTHONPATH=. python3 tools/torch_sweep_eigdc.py [--batch 128 512] [--reps 5]
        [--configs "default;kpm=32"]
"""

import argparse
import subprocess
import sys

import numpy as np

CONFIGS = {
    "default": {},
    "q=high": {"q_prec": "high"},
    "deskew=high": {"deskew_prec": "high"},
    "q+deskew=high": {"q_prec": "high", "deskew_prec": "high"},
    "ns_global=5": {"ns_global": 5},
    "ns_global=4": {"ns_global": 4},
    "dm_ns=1": {"dm_ns": 1},
    "bottom=256": {"bottom": 256},
    "polish-lean": {"ns_global": 5, "dm_ns": 1},
    "dm=(1,1,0)": {"dm_iters": (1, 1, 0)},
    "dm=(1,1,0),ns5": {"dm_iters": (1, 1, 0), "ns_global": 5},
    "dm=(0,0,0),ns5": {"dm_iters": (0, 0, 0), "ns_global": 5},
    "dm=(0,0,0),ns4": {"dm_iters": (0, 0, 0), "ns_global": 4},
    "dm=(0,0,0),ns4,dmns1": {"dm_iters": (0, 0, 0), "ns_global": 4, "dm_ns": 1},
    "strip@n": {"strip": 1024},
    "strip@n,ns5": {"strip": 1024, "ns_global": 5},
    "strip@n,base256": {"strip": 1024, "base": 256},
    "ns_global=3": {"ns_global": 3},
    "base=256": {"base": 256},
    "base=320": {"base": 320},
    "chain=4": {"chain": 4},
    "chain=3,base=256": {"chain": 3, "base": 256},
    "kpm=32": {"kpm_degree": 32},
    "sign=(7,3)": {"sign_iters": (7, 3)},
    "lean-combo": {"base": 256, "kpm_degree": 32, "sign_iters": (7, 3)},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[128, 512])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--configs", type=str, default=None,
                    help="semicolon-separated subset of config names "
                         "(names contain commas)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_sweep_eigdc: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import vivit_tpu_torch as vtt
    from vivit_tpu_torch.eigdc import eigvalsh_dc
    from vivit_tpu_torch.kernels import jacobi_cuda as jc

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    names = list(CONFIGS) if args.configs is None else args.configs.split(";")
    model = cs.port_model()
    loss = vtt.CrossEntropyLoss("mean")
    for batch in args.batch:
        X, y = cs.port_batch(batch)
        gram = cs.deflated_gram(model, loss, X, y)[2]
        del X, y
        torch.cuda.empty_cache()
        n = gram.shape[0]
        ref = torch.linalg.eigvalsh(gram.double())
        print(f"N={batch}: deflated Gram {n}², reps {args.reps} (CUDA events, "
              "median [min-max]), guard=None", flush=True)
        for name in names:
            kw = CONFIGS[name]

            def solve():
                return eigvalsh_dc(gram, guard=None, **kw)

            solve()  # below the strip the first call per configuration captures
            ev, launches = cs.launches_of(jc, solve)
            ratio, bad = cs.spectrum_ratio(ev, ref)
            times = cs.cuda_times(solve, reps=args.reps, warmup=1)
            print(f"  {name:22s} {cs.spread(times)}  Jacobi launches {launches}  "
                  f"violations {bad}/{n}  max err/tol {ratio:.3f}", flush=True)
        del gram
    return 0


if __name__ == "__main__":
    sys.exit(main())
