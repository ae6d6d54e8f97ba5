#!/usr/bin/env python3
"""A blocked Gram timed two ways on one CUDA card, at bf16 operands with
f32 sums: a loop of one product a ``precision._K_BLOCK`` block, and
``precision.gram_blocked``'s one batched product of ``_BATCHED_K`` blocks.

    PYTHONPATH=. python3 tools/torch_gram_routes.py

For each column count ``n`` (16, the LM cell's, to 1152, the ViT cell's) a
chunk as ``TokenFactor.gram`` forms it, ``K = 2^28 / n`` columns
(``structured.TOKEN_CHUNK_BYTES`` of f32), of random normals: the loop of
one product a ``2^14`` block and the batched product of ``2^11`` blocks,
CUDA events, median of 10 in turns; the scratch each allocates beyond its
input; each Gram's error against float64 (relative Frobenius, and the mean
bias of its diagonal).  Prints one JSON line last.
"""

import json
import subprocess
import sys

COLS = (16, 32, 64, 128, 256, 512, 1152)


def main():
    import numpy as np
    import torch

    from vivit_tpu_torch import precision

    if not torch.cuda.is_available():
        print("torch_gram_routes: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    routes = ("loop", "batched")

    def run(route, flat):
        if route == "batched":
            return precision.gram_blocked(flat, torch.bfloat16)
        out, step = None, precision._K_BLOCK
        for k0 in range(0, flat.shape[1], step):
            g = precision.gram(flat[:, k0:k0 + step], torch.bfloat16)
            out = g if out is None else out.add_(g)
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for n in COLS:
        k = (1 << 28) // n
        flat = torch.randn((n, k), generator=gen, device="cuda").bfloat16()
        low = flat.double()
        ref = low @ low.T
        del low
        row = {"cols": n, "k": k}
        for route in routes:
            run(route, flat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = run(route, flat)
            torch.cuda.synchronize()
            row[f"{route}_scratch_mb"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            diag = torch.diagonal(got.double() - ref) / torch.diagonal(ref)
            row[f"{route}_rel_err"] = float(torch.linalg.matrix_norm(got.double() - ref)
                                            / torch.linalg.matrix_norm(ref))
            row[f"{route}_diag_bias"] = float(diag.mean())
            del got
        times = {route: [] for route in routes}
        for _ in range(10):
            for route in routes:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                run(route, flat)
                end.record()
                torch.cuda.synchronize()
                times[route].append(start.elapsed_time(end))
        for route in routes:
            row[f"{route}_ms"] = float(np.median(times[route]))
        row["batched_over_loop"] = row["batched_ms"] / row["loop_ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        del flat, ref
        torch.cuda.empty_cache()
    print(json.dumps({"gram_routes": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
