"""Run one cell of the benchmark of ``vivit_tpu_torch`` once.

    python3 benchmark/run.py --workload n512_spectrum --seed 7 --seconds 51 --trace 0

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (``BENCHMARK.json``).  The last line of standard output is
the result, one JSON object; the last lines of standard error give each
number that decided ``correct`` beside its limit.  ``--trace 1`` adds a
block of queries under ``torch.profiler`` and reports the per-layer
metrics instead of the end-to-end ones.  Exits non-zero, with no result,
without enough cards, or if ``jax``, ``jaxlib``, ``flax`` or ``vivit_tpu``
was imported.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
CACHE = os.path.join(CHECKOUT, ".bench_cache")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().replace("\n", "; ") or f"not read ({out.stderr.strip()})"


def main(argv=None):
    args = parse(argv)
    # every cache of the program and of its libraries inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, HERE)
    sys.path.insert(1, CHECKOUT)
    import torch

    import harness

    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as fh:
        chips = {w["name"]: w["chips"] for w in json.load(fh)["workloads"]}
    if args.workload not in chips:
        print(f"run.py: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("run.py: no CUDA device; the benchmark runs only on a card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips[args.workload]:
        print(f"run.py: {args.workload} needs {chips[args.workload]} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} present, "
          f"{chips[args.workload]} used; nvidia-smi name, power limit: {power_limit()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    result = harness.run(args, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: the run imported {bad}; no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
