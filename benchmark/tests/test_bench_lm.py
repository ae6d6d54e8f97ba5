"""The LM cell's files on the CPU, at a tiny size (hidden 32, 2 heads, one
dense and one MoE layer, 8 routed experts top-2 with 4 held, a vocabulary of
50, 3 sequences of 12 tokens, 2 draws): the LM's own count
(:mod:`counts_lm`) against the network's parameters and a tally of its
products, the reference free of the program, and a tiny LM cell through
the harness, added as files only, with its metrics and its decisions
checked."""

import json
import os
import subprocess
import sys

import torch

import counts_lm
import harness
import tiny

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL_NAME = "moonlight_s16_t2048_mc1_spectrum"
TINY_LM = {
    "name": "tiny_lm", "source": "a small copy of Moonlight-16B-A3B for CPU tests",
    "network": "moonlight", "hidden_size": 32, "num_attention_heads": 2,
    "qk_nope_head_dim": 8, "qk_rope_head_dim": 4, "v_head_dim": 8, "kv_lora_rank": 16,
    "num_hidden_layers": 2, "first_k_dense_replace": 1, "intermediate_size": 48,
    "moe_intermediate_size": 16, "n_routed_experts": 4, "router_experts": 8,
    "num_experts_per_tok": 2, "n_shared_experts": 1, "routed_scaling_factor": 2.446,
    "norm_topk_prob": True, "rms_norm_eps": 1e-5, "rope_theta": 50000.0, "vocab_size": 50,
    "init": {"std": 0.3}, "image": [12], "batch": 3, "num_classes": 50,
    "loss": {"name": "cross_entropy", "reduction": "mean"},
    "settings": {"precision": "highest", "gram_precision": "bf16", "deflate_ce_null": False,
                 "eig_backend": "dc"},
    "reduced": [], "assumed": {},
}
CELL = {"config": "tiny_lm", "entry": "eigvalsh_structured_lm",
        "kwargs": {"mc_samples": 2, "key": 2 ** 40 + 3, "engine": "tapped"},
        "check_answers": 2, "check_among": 4, "trace_queries": 2,
        "limits": {"bulk_gap": 1e-4, "abs_gap": 1e-4, "zeros_off": 0, "routing_off": 0,
                   "labels_off": 0}, "why": "tiny"}
LM_METRICS = ("lm_query_mfu_pct", "routed_gram_ms", "routing_ms", "generic_vt_params",
              "vtransform_ms", "gram_ms", "token_gram_ms")


def test_counts_match_the_network_and_a_tally_of_its_products():
    """Parameters against the module's, at the tiny size and the cell's;
    the forward's multiply-adds against ``torch.utils.flop_counter``'s count
    of its products (two per multiply-add) on a batch whose routing is
    even, as the count assumes (each token picks one held expert, in turn,
    and one held elsewhere): its Linear products (``mm``) equal, and the
    attention's batched products the full ``T×T`` square that the causal
    count halves, ``T(T+1)/2`` pairs kept of ``T²``."""
    from torch.utils.flop_counter import FlopCounterMode

    net = harness.load_module(BENCH, "networks", "moonlight")
    model = net.build(TINY_LM, torch.device("cpu"), torch.Generator().manual_seed(3))
    assert counts_lm.parameters(TINY_LM) == sum(p.numel() for p in model.parameters())
    full = json.load(open(os.path.join(BENCH, "configs", "moonlight_16b_a3b_l5_e8.json")))
    assert counts_lm.parameters(full) == full["parameters"] == 568484352
    with torch.device("meta"):
        assert sum(p.numel() for p in net.Net(full).parameters()) == full["parameters"]
    s, t = TINY_LM["batch"], TINY_LM["image"][0]
    # 12 tokens of each sequence over the held experts in turn: rows even
    pick = torch.arange(s * t) % 4
    model.routing["replay"] = [torch.stack([pick, pick + 4], dim=1)]
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.randn(s, t))
    model.routing["replay"] = None
    cfg = {**TINY_LM, "mc_samples": 1}
    counted = fc.get_flop_counts()["Global"]
    parts = counts_lm.query_parts(cfg)
    # the count's even routing gives each held expert S·T·2/8 rows: here 9
    assert counts_lm.expert_rows(cfg) == s * t * 2 / 8 == 9
    layers = TINY_LM["num_hidden_layers"]
    attention = 2 * s * layers * counts_lm.attention_macs(cfg)
    assert counted[torch.ops.aten.mm] == parts["forward"][0] - attention
    assert counted[torch.ops.aten.bmm] * (t + 1) == attention * 2 * t


def test_lm_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            f"sys.path[:0] = [{BENCH!r}]\n"
            "from reference import ggn_lm\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('vivit_tpu_torch', 'vivit_tpu', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout.strip()
    assert out == "[]"


def _lm_tree(tmp):
    root = tiny.make_tree(tmp)
    with open(os.path.join(root, "configs", "tiny_lm.json"), "w") as fh:
        json.dump(TINY_LM, fh)
    with open(os.path.join(root, "workloads", "tiny_lm_spectrum.json"), "w") as fh:
        json.dump(CELL, fh)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "tiny_lm", "source": "tests", "reduced": [],
                             "file": "benchmark/configs/tiny_lm.json", "why": "tests"})
    bench["workloads"].append({"name": "tiny_lm_spectrum", "config": "tiny_lm",
                               "traffic": "tiny_lm_spectrum", "chips": 1, "why": "tests"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if CELL_NAME in metric.get("workloads", ()):
            metric["workloads"].append("tiny_lm_spectrum")
    with open(path, "w") as fh:
        json.dump(bench, fh)
    return root


def test_tiny_lm_cell_runs_through_the_harness(tmp_path):
    root = _lm_tree(str(tmp_path))
    res, proc = tiny.run_cpu(root, "tiny_lm_spectrum", seed=2 ** 33 + 5, trace=1)
    assert res is not None, proc.stderr[-4000:]
    assert res["correct"] is True, res["checks"]
    metrics = res["metrics"]
    for name in LM_METRICS:
        assert metrics[name]["value"] is not None, name
    assert metrics["generic_vt_params"]["value"] == 0
    assert res["checks"]["routing_off"]["value"] == res["checks"]["labels_off"]["value"] == 0
    assert res["info"]["not_compared"]["routing_invalid"] == 0
    res, proc = tiny.run_cpu(root, "tiny_lm_spectrum", seed=7, trace=0)
    assert res is not None and res["correct"] is True, proc.stderr[-4000:]
    assert {"query_ms", "peak_mem_gb", "setup_s"} <= set(res["metrics"])
