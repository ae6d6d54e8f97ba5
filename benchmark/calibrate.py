"""Readings that the limits of ``correct`` are set from, for a one-card cell.

    python3 benchmark/calibrate.py --workload n512_spectrum --seeds 1001-1012 \
        --control-seeds 1001-1003

For each seed, the cell's network and batches as a run makes them, queries
0 and 1 as the run's set-up, then the program's answer to each query a run
checks, twice (replayed), against the reference: the largest of each number
over the seed's answers.  For each control seed, the control, the reference computed
one precision step below the configuration's float32 (TF32), in the
program's place.  Prints one JSON line per seed, then the lower reading (the
largest over the program's seeds) and the upper reading (the smallest over
the control's) of each number.  Needs a card.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def seeds(text):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def worst(readings):
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control-seeds", type=seeds, default=[])
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import torch

    import harness

    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as fh:
        cell = harness.Cell(args.workload, json.load(fh))
    if cell.chips != 1 or not torch.cuda.is_available():
        print("calibrate.py: a one-card cell, on a card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    program, control = {}, {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        model, batches = harness.make_inputs(cell, seed, device)
        ctx = harness.Context(cell, device, 0, 1, model, batches)
        query = cell.entry.prepare(ctx) if seed in args.seeds else None
        if query:
            for q in range(2):
                query(*batches(q))
        readings, controls = [], []
        for q in cell.checked(seed):
            outs = [query(*batches(q)), query(*batches(q))] if query else []
            torch.cuda.synchronize()
            ref = cell.entry.reference(ctx, q)
            readings += [cell.entry.compare(ctx, q, out, ref) for out in outs]
            if seed in args.control_seeds:
                ctl = cell.entry.reference(ctx, q, control=True)
                controls.append(cell.entry.compare(ctx, q, ctl, ref))
        del query
        cell.entry.release(ctx)
        torch.cuda.empty_cache()
        line = {"seed": seed}
        if readings:
            program[seed] = line["program"] = worst(readings)
        if controls:
            control[seed] = line["control"] = {k: min(c[k] for c in controls)
                                               for k in controls[0]}
        print(json.dumps(line), flush=True)
    names = cell.workload["limits"]
    print(json.dumps({
        "lower": {k: max(r[k] for r in program.values()) for k in names} if program else None,
        "upper": {k: min(r[k] for r in control.values()) for k in names} if control else None,
        "program_seeds": sorted(program), "control_seeds": sorted(control)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
