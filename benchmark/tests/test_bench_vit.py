"""The ViT cell's files on the CPU, at a tiny size (8x8 images, patch 4,
width 8, 2 heads, MLP 16, 2 blocks, 3 classes): the grouped reference
(:mod:`reference.ggn_blocks`) against :mod:`reference.ggn` for every
grouping, and free of the program; the ViT's own count
(:mod:`counts_vit`) against a tally of the network's products; and a tiny
ViT cell through the harness, added as files only, with its metrics."""

import json
import os
import subprocess
import sys

import pytest
import torch

import counts_vit
import harness
import tiny
from reference import ggn, ggn_blocks

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH)
TINY_VIT = {
    "name": "tiny_vit", "source": "a small copy of ViT-S/16 for CPU tests", "network": "vit",
    "image": [8, 8, 3], "patch": 4, "width": 8, "heads": 2, "mlp": 16, "depth": 2,
    "num_classes": 3, "loss": {"name": "cross_entropy", "reduction": "mean"}, "batch": 4,
    "settings": {"precision": "highest", "gram_precision": "bf16", "deflate_ce_null": True,
                 "eig_backend": "dc"},
    "init": {"std": 0.5, "ln_eps": 1e-6}, "reduced": [], "assumed": {},
}
CELL = {"config": "tiny_vit", "entry": "eigvalsh_structured_vit", "kwargs": {},
        "check_answers": 2, "check_among": 6, "trace_queries": 3,
        "limits": {"bulk_gap": 1e-3, "zeros_off": 0}, "why": "tiny"}
VIT_METRICS = ("token_gram_ms", "token_gram_roofline", "vit_query_mfu_pct",
               "generic_vt_params")


@pytest.fixture(scope="module")
def net():
    vit = harness.load_module(BENCH, "networks", "vit")
    return vit.build(TINY_VIT, torch.device("cpu"), torch.Generator().manual_seed(3))


def _batch(seed=4):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((4, 8, 8, 3), generator=gen)


@pytest.mark.parametrize("group_numel", [1, 40, 600, 10 ** 9])
@pytest.mark.parametrize("low", [torch.bfloat16, torch.float32])
def test_grouped_gram_equals_whole_columns(net, group_numel, low):
    """Each parameter alone, a few together, whole blocks, one group: the
    Gram of :mod:`ggn` over the same rounding of the same blocks.  Its
    rounded blocks sum in float32 on the CPU, ``ggn_blocks``' in float64:
    1e-6 of the largest entry holds that difference (7.5e-8 seen)."""
    X = _batch()
    names = [n for n, _ in net.named_parameters()]
    dense = ggn_blocks.dense_2d_weights(net, X[:1])
    assert dense == {"head.weight"}
    low_names = [n for n in names if n not in dense]
    want = ggn.Columns(net, X, deflate=True, dtype=torch.float64, tf32=False).gram(
        low_names, low, False)
    got = ggn_blocks.gram(net, X, low=low, dtype=torch.float64, tf32=False,
                          group_numel=group_numel, block=3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * want.abs().max())


def test_groups_are_consecutive_and_bounded():
    sizes = [5, 30, 2, 100, 1, 1]
    assert ggn_blocks.groups(sizes, 40) == [[0, 1, 2], [3], [4, 5]]
    assert ggn_blocks.groups(sizes, 1) == [[i] for i in range(6)]
    assert ggn_blocks.groups(sizes, 10 ** 6) == [list(range(6))]


def test_grouped_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            f"sys.path[:0] = [{BENCH!r}]\n"
            "from reference import ggn_blocks\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('vivit_tpu_torch', 'vivit_tpu', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout.strip()
    assert out == "[]"


def test_counts_match_a_tally_of_the_products(net):
    """Parameters against the module's; the forward's multiply-adds
    against ``torch.utils.flop_counter``'s count of its matrix products
    and convolution (two per multiply-add); the token blocks' expansion and
    Gram against the counted products of the program's ``TokenFactor``."""
    from torch.utils.flop_counter import FlopCounterMode

    from vivit_tpu_torch.structured import TokenFactor

    cfg = dict(TINY_VIT)
    assert counts_vit.parameters(cfg) == sum(p.numel() for p in net.parameters())
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(_batch())
    assert fc.get_total_flops() == 2 * cfg["batch"] * counts_vit.forward_macs(cfg)
    t, cols = counts_vit.tokens(cfg), (cfg["num_classes"] - 1) * cfg["batch"]
    flops = 0
    for i, o in counts_vit.token_linears(cfg):
        leaf = TokenFactor(z=torch.randn(cfg["batch"], t, i),
                           delta=torch.randn(cfg["num_classes"] - 1, cfg["batch"], t, o))
        with FlopCounterMode(display=False) as fc:
            leaf.gram()
        flops += fc.get_total_flops()
    parts = counts_vit.token_parts(cfg)
    assert flops == parts["token_expansion"][0] + parts["token_gram"][0]
    full = json.load(open(os.path.join(BENCH, "configs", "vit_s16_c10_n128.json")))
    assert counts_vit.parameters(full) == full["parameters"] == 21669514
    assert cols == 8


def _vit_tree(tmp):
    root = tiny.make_tree(tmp)
    with open(os.path.join(root, "configs", "tiny_vit.json"), "w") as fh:
        json.dump(TINY_VIT, fh)
    with open(os.path.join(root, "workloads", "tiny_vit_spectrum.json"), "w") as fh:
        json.dump(CELL, fh)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "tiny_vit", "source": "tests", "reduced": [],
                             "file": "benchmark/configs/tiny_vit.json", "why": "tests"})
    bench["workloads"].append({"name": "tiny_vit_spectrum", "config": "tiny_vit",
                               "traffic": "tiny_vit_spectrum", "chips": 1, "why": "tests"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "vit_s16_n128_spectrum" in metric.get("workloads", ()):
            metric["workloads"].append("tiny_vit_spectrum")
    with open(path, "w") as fh:
        json.dump(bench, fh)
    return root


def test_tiny_vit_cell_runs_through_the_harness(tmp_path):
    root = _vit_tree(str(tmp_path))
    res, proc = tiny.run_cpu(root, "tiny_vit_spectrum", trace=1)
    assert res is not None, proc.stderr[-4000:]
    assert res["correct"] is True, res["checks"]
    metrics = res["metrics"]
    for name in VIT_METRICS + ("vtransform_ms", "gram_ms", "guard_trip_pct"):
        assert metrics[name]["value"] is not None, name
    assert metrics["generic_vt_params"]["value"] == 0
    assert metrics["token_gram_ms"]["value"] > 0
    res, proc = tiny.run_cpu(root, "tiny_vit_spectrum", trace=0)
    assert res is not None and res["correct"] is True, proc.stderr[-4000:]
    assert {"query_ms", "peak_mem_gb", "setup_s"} <= set(res["metrics"])
