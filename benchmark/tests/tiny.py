"""A copy of the benchmark's tree with tiny cells added as files only, for
runs on the CPU: the real networks, entries, metrics and reference, and a
``BENCHMARK.json`` that names the tiny cells beside the real ones."""

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH)

TINY_CONFIG = {
    "name": "tiny_cnn", "source": "a small copy of DeepOBS cifar10_3c3d for CPU tests",
    "network": "cnn3c3d", "image": [8, 8, 3],
    "conv": [{"out": 4, "kernel": 3, "padding": 0}, {"out": 4, "kernel": 3, "padding": 1}],
    "pool": {"kernel": 3, "stride": 2, "padding": 1}, "dense": [8], "num_classes": 3,
    "loss": {"name": "cross_entropy", "reduction": "mean"}, "batch": 8,
    "settings": {"precision": "highest", "gram_precision": "bf16", "deflate_ce_null": True,
                 "eig_backend": "dc"},
    "init": {"weights": "lecun_normal", "bias_std": 0.05}, "reduced": [], "assumed": {},
}
TINY_CELLS = {
    "tiny_spectrum": {"config": "tiny_cnn", "entry": "eigvalsh_structured", "kwargs": {},
                      "check_answers": 2, "check_among": 6, "trace_queries": 3,
                      "limits": {"abs_gap": 1e-4, "bulk_gap": 1e-4, "zeros_off": 0},
                      "why": "tiny"},
    "tiny_dp_spectrum": {"config": "tiny_cnn", "entry": "eigvalsh_dp_structured",
                         "kwargs": {}, "samples_per_rank": 2, "check_answers": 2, "check_among": 6,
                         "trace_queries": 3,
                         "limits": {"top_gap": 1e-4, "bulk_gap": 1e-4, "zeros_off": 0},
                         "why": "tiny"},
}
CHIPS = {"tiny_dp_spectrum": 4}


def make_tree(tmp):
    """``tmp/benchmark`` with the tiny cells, ``tmp/BENCHMARK.json`` naming
    them; returns the new benchmark folder."""
    root = os.path.join(tmp, "benchmark")
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(root, "configs", "tiny_cnn.json"), "w") as fh:
        json.dump(TINY_CONFIG, fh)
    for name, cell in TINY_CELLS.items():
        with open(os.path.join(root, "workloads", f"{name}.json"), "w") as fh:
            json.dump(cell, fh)
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "tiny_cnn", "source": "tests", "reduced": [],
                             "file": "benchmark/configs/tiny_cnn.json", "why": "tests"})
    for name in TINY_CELLS:
        bench["workloads"].append({"name": name, "config": "tiny_cnn", "traffic": name,
                                   "chips": CHIPS.get(name, 1), "why": "tests"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in metric:
                metric["workloads"].append(name)
    # the readers that no metric of BENCHMARK.json names yet run in the tiny cells too
    named = {m["name"].split(".")[0] for m in bench["per_layer"]}
    for reader in sorted(os.listdir(os.path.join(root, "metrics"))):
        if reader.endswith(".py") and reader[:-3] not in named:
            bench["per_layer"].append({"name": reader[:-3], "unit": "x", "better": "lower",
                                       "source": "device_trace", "layer": "tests",
                                       "moves": "query_ms", "workloads": list(TINY_CELLS)})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root


def run_cpu(root, workload, seed=3, seconds=0.3, trace=0, plant=None, timeout=600):
    """A run of ``workload`` on the CPU in a fresh process (the look for a
    card skipped): ``(result dict or None, completed process)``."""
    code = (
        "import sys, json, time, argparse\n"
        f"sys.path[:0] = [{root!r}, {CHECKOUT!r}]\n"
        "import harness\n"
        f"args = argparse.Namespace(workload={workload!r}, seed={seed}, seconds={seconds}, "
        f"trace={trace}, plant={plant!r})\n"
        f"res = harness.run(args, time.time(), device_type='cpu', root={root!r})\n"
        "print(json.dumps(res))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, cwd=os.path.dirname(root))
    if proc.returncode != 0:
        return None, proc
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc
