#!/usr/bin/env python3
"""The token blocks' columns on the tensor cores
(``vivit_tpu_torch/csrc/token_expand.cu``) at ViT-S/16's chunk shapes
(N=128, ``CF = 9``, ``T = 197``; qkv, proj, fc1, fc2) and at
Moonlight-16B-A3B's (16 columns over 2,048 positions; an expert's zero-padded
per-sample segments from a recorded routing), on one CUDA card.

    PYTHONPATH=. python3 tools/torch_token_expand.py

Runs ``chip_smoke.py``'s phase 18 alone, after building the kernel (its
registers and spills printed): for each layer's chunk the f32 ``bmm`` of
``TokenFactor.expand`` (the route before the kernel) timed first, then the
kernel's time beside its bound and its plain version's, the errors of kernel
and ``bmm`` against float64, the share of their bf16 roundings that differ,
and a bf16 ``TokenFactor.gram`` under the profiler with its launches equal
to ``LAUNCHES``; each route's time a query (the layers' chunks in 12
blocks); the same checks at the LM's chunks, their launches one a range
of positions; the routed block also against its ragged segments in
float64.  Prints the kernels' rows as one JSON line last.
"""

import json
import subprocess
import sys


def main():
    import torch

    import chip_smoke as smoke
    from vivit_tpu_torch.kernels import toolchain

    if not torch.cuda.is_available():
        print("torch_token_expand: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    _, build_s, log = toolchain.build("token_expand")
    print(f"csrc/token_expand.cu: {build_s:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}", flush=True)
    try:
        rows = smoke.phase_token_expand()
    except smoke.SmokeFailure as exc:
        print(f"torch_token_expand: FAIL: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"token_expand": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
