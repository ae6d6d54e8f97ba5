"""ViT-S/16 at N=128 through ``vivit_tpu_torch.eigvalsh_structured`` on one
card, as the benchmark's cell ``vit_s16_n128_spectrum`` runs it: the eager
route's query time, peak memory and stages; the token blocks' Gram, its
time and its scratch; a query with every guard forced to trip; the plain
reference's seconds per answer and the answer's readings against it (and
the control's); and the captured route's capture, replays and peak.

    PYTHONPATH=. python3 tools/torch_vit_routes.py [--seed S] [--queries Q]
        [--reference] [--captured] [--tiny]

Prints one JSON line per measurement.  ``--tiny`` runs a tiny ViT on the
CPU (the same steps, to check the tool; its numbers measure nothing).
``--captured`` comes last: a capture that does not fit raises, and the
line says so.
"""

import argparse
import functools
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
BENCH = os.path.join(CHECKOUT, "benchmark")
CELL = "vit_s16_n128_spectrum"
TINY = {"image": [8, 8, 3], "patch": 4, "width": 8, "heads": 2, "mlp": 16, "depth": 2,
        "num_classes": 3, "batch": 4, "init": {"std": 0.5, "ln_eps": 1e-6}}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=2 ** 31 + 17)
    p.add_argument("--queries", type=int, default=4)
    p.add_argument("--reference", action="store_true")
    p.add_argument("--captured", action="store_true")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    sys.path[:0] = [BENCH, CHECKOUT]
    import torch

    import harness
    import program
    from vivit_tpu_torch import eigdc, engines, structured, tapped
    from vivit_tpu_torch.utils import graphs, trace

    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as fh:
        cell = harness.Cell(CELL, json.load(fh))
    if args.tiny:
        cell.config = dict(cell.config, **TINY)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def mem():
        if not on_card:
            return {}
        return {"allocated_gb": torch.cuda.memory_allocated(device) / 1e9,
                "peak_allocated_gb": torch.cuda.max_memory_allocated(device) / 1e9,
                "peak_reserved_gb": torch.cuda.max_memory_reserved(device) / 1e9}

    model, batches = harness.make_inputs(cell, args.seed, device)
    ctx = harness.Context(cell, device, 0, 1, model, batches)
    query = cell.entry.prepare(ctx)

    def timed(q):
        sync()
        t0 = time.perf_counter()
        out = query(*batches(q))
        sync()
        return out, time.perf_counter() - t0

    # the eager route (the rule's), first call and later ones
    tapped.GENERIC_PARAMS = structured.TOKEN_BLOCKS = 0
    kept = {}
    _, first = timed(0)
    times = []
    for q in range(1, 1 + args.queries):
        kept[q], t = timed(q)
        times.append(t)
    emit(step="eager", first_s=first, query_s=times, generic_params=tapped.GENERIC_PARAMS,
         token_blocks=structured.TOKEN_BLOCKS, calls=1 + args.queries,
         entries=len(graphs.entries()), **mem())

    # the stages of one query, by its spans
    trace.collect()
    trace.enable(True)
    timed(1 + args.queries)
    sync()
    trace.enable(None)
    stages = {}
    for r in trace.collect():
        stages[r.name] = stages.get(r.name, 0.0) + r.device_ms
    emit(step="stages", device_ms=stages)

    # the token blocks' Gram alone: its time and its scratch above its inputs
    from vivit_tpu_torch.precision import _PRECISIONS, full_f32
    from vivit_tpu_torch.structured import (TokenFactor, gram_matrix_mixed,
                                            structured_ggn_sqrt_vt)

    X, y = batches(2)
    with full_f32():
        vt = structured_ggn_sqrt_vt(model, program.loss(cell.config), X, y,
                                    deflate_ce_null=True)
        paths = [k for k, v in vt.items() if isinstance(v, TokenFactor)]
        low = _PRECISIONS[cell.config["settings"]["gram_precision"]]
        sync()
        before = torch.cuda.memory_allocated(device) if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        g = gram_matrix_mixed(vt, paths, generic_precision=low)
        sync()
        token_s = time.perf_counter() - t0
        scratch = (torch.cuda.max_memory_allocated(device) - before) / 1e9 if on_card else None
    emit(step="token_gram", seconds=token_s, blocks=len(paths), scratch_gb=scratch,
         gram_gb=g.numel() * 4 / 1e9, chunk_bytes=structured.TOKEN_CHUNK_BYTES)
    del vt, g

    # a query whose every guard trips: the solve rerun on the vendor
    solver = eigdc.eigh_dc
    eigdc.eigh_dc = functools.partial(solver, guard=0.0)
    trips = eigdc.TRIPS
    try:
        _, tripped = timed(2)
    finally:
        eigdc.eigh_dc = solver
    emit(step="guard_trip", query_s=tripped, trips=eigdc.TRIPS - trips)

    if args.reference:
        for q in sorted(kept)[:1]:
            sync()
            t0 = time.perf_counter()
            ref = cell.entry.reference(ctx, q)
            sync()
            ref_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ctl = cell.entry.reference(ctx, q, control=True)
            sync()
            ctl_s = time.perf_counter() - t0
            emit(step="reference", query=q, reference_s=ref_s, control_s=ctl_s,
                 program=cell.entry.compare(ctx, q, kept[q], ref),
                 control=cell.entry.compare(ctx, q, ctl, ref), **mem())

    if args.captured and on_card:
        graphs.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        rule = engines.captured
        engines.captured = lambda *a: True
        try:
            _, capture_s = timed(2)
            replays = [timed(q)[1] for q in range(3, 3 + args.queries)]
            emit(step="captured", capture_s=capture_s, query_s=replays,
                 entries=len(graphs.entries()), **mem())
        except torch.cuda.OutOfMemoryError as e:
            emit(step="captured", failed=f"out of memory: {str(e).splitlines()[0]}", **mem())
        finally:
            engines.captured = rule
            graphs.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
