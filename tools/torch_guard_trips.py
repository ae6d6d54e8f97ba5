#!/usr/bin/env python3
"""Which queries of a benchmark cell trip ``eigh_dc``'s guard, query by
query, on one CUDA card, for the package of the checkout it runs from.

    python3 tools/torch_guard_trips.py --queries 48 --seeds 2147490101 2147490102 \\
        [--key K] [--out FILE]

For each seed the cell's inputs and queries are those of
``benchmark/run.py`` (``harness.make_inputs``); each query runs once,
synchronized, and counts as tripped when ``eigdc.TRIPS`` moved.  ``--key``
seeds the solver's own draws (``eigh_dc``'s ``key``, 0 by default) where
the entry leaves it unset: the same batches under other draws, the control
that tells a trip that follows the batch from one that follows the solver's
trajectory.  Prints one JSON line a seed and writes them all to ``--out``.
"""

import argparse
import json
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmark"))
sys.path.insert(0, ROOT)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", default="n512_spectrum")
    parser.add_argument("--queries", type=int, default=48)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--key", type=int, default=None)
    parser.add_argument("--out")
    args = parser.parse_args()

    import torch

    import harness
    from vivit_tpu_torch import eigdc

    if args.key is not None:
        solve = eigdc.eigh_dc

        def keyed(*a, key=None, **kw):
            return solve(*a, key=args.key if key is None else key, **kw)

        # the entries import eigh_dc from the module at each call
        eigdc.eigh_dc = keyed
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.Cell(args.workload, json.load(f))
    device = torch.device("cuda", 0)
    out = {}
    for seed in args.seeds:
        model, batches = harness.make_inputs(cell, seed, device)
        query = cell.entry.prepare(harness.Context(cell, device, 0, 1, model, batches))
        tripped, times = [], []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for q in range(args.queries):
                before = eigdc.TRIPS
                t0 = time.perf_counter()
                query(*batches(q))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if eigdc.TRIPS != before:
                    tripped.append(q)
        out[seed] = {"key": args.key, "tripped": tripped,
                     "median_ms": sorted(times)[len(times) // 2]}
        print(seed, json.dumps(out[seed]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
