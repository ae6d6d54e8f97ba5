"""The counts of the yardstick against hand-worked values, and the
profiler arithmetic on made-up timelines."""

import json
import os

import pytest

import counts
import harness
import timeline

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", ["c10_3c3d_n128", "c10_3c3d_n512"])
def test_3c3d_parameters_and_macs(name):
    cfg = config(name)
    layers = harness.load_module(BENCH, "networks", cfg["network"]).layers(cfg)
    # conv 3->64 5x5 on 28x28, 64->96 3x3 on 12x12, 96->128 3x3 on 6x6;
    # dense 1152->512->256->10
    assert [layer.get("out_hw") for layer in layers[:3]] == [(28, 28), (12, 12), (6, 6)]
    assert layers[3]["in"] == 128 * 3 * 3
    assert counts.parameters(layers) == 895_210 == cfg["parameters"]
    macs = [counts.layer_macs(layer) for layer in layers]
    assert macs == [3_763_200, 7_962_624, 3_981_312, 589_824, 131_072, 2_560]
    assert counts.forward_macs(layers) == 16_430_592


def test_network_matches_its_layers():
    import torch

    cfg = config("c10_3c3d_n128")
    net_file = harness.load_module(BENCH, "networks", cfg["network"])
    gen = torch.Generator().manual_seed(3)
    net = net_file.build(cfg, torch.device("cpu"), gen)
    assert sum(p.numel() for p in net.parameters()) == 895_210
    assert net(torch.zeros(2, 32, 32, 3)).shape == (2, 10)
    w = dict(net.named_parameters())
    # LeCun-normal kernels, normal(0.05) biases
    assert abs(w["convs.1.weight"].std().item() * (64 * 9) ** 0.5 - 1) < 0.02
    assert abs(w["denses.0.bias"].std().item() / 0.05 - 1) < 0.15
    again = net_file.build(cfg, torch.device("cpu"), torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(), again.parameters()))


def test_query_parts_hand_worked():
    cfg = config("c10_3c3d_n128")
    layers = harness.load_module(BENCH, "networks", cfg["network"]).layers(cfg)
    parts = counts.query_parts(layers, 128, 10)
    d_low = 4_800 + 55_296 + 110_592 + 64 + 96 + 128 + 512 + 256 + 10
    assert parts["gram_conv"] == (2 * 1280 ** 2 * d_low, "bfloat16")
    assert parts["forward"][0] == 2 * 128 * 16_430_592
    assert parts["backward"][0] == 2 * 1280 * (16_430_592 - 3_763_200) \
        + 2 * 1280 * (3_763_200 + 7_962_624 + 3_981_312)
    assert parts["eigensolve"][0] == pytest.approx(4 / 3 * 1280 ** 3)
    least = counts.least_seconds(parts)
    assert 1.5e-3 < least < 2.5e-3  # ~1.8 ms: 77 GFLOP f32, 0.56 TFLOP bf16
    assert counts.least_seconds(parts, chips=4) == pytest.approx(least / 4)


def test_roofline_of_batches():
    # [16,150,150]: 16 * (10/3) 150^3 flops against 4 (2 b m^2 + b m + b) bytes
    flops = 16 * (4 / 3 + 2) * 150 ** 3
    moved = 4 * (2 * 16 * 150 ** 2 + 16 * 150 + 16)
    assert counts.roofline_seconds([(16, 150)]) == pytest.approx(
        max(flops / 67e12, moved / 3.35e12))
    assert counts.roofline_seconds([(16, 150), (1, 96)]) > counts.roofline_seconds([(16, 150)])


def test_quantile():
    assert counts.quantile([3, 1, 2], 0.5) == 2
    assert counts.quantile(list(range(101)), 0.95) == pytest.approx(95)


def ev(name, dev, s, e):
    return timeline.Event(name, dev, s, e)


def test_union_idle_and_counts():
    events = [ev("k1", True, 0, 10), ev("k2", True, 5, 20), ev("k3", True, 30, 40),
              ev("cudaLaunchKernel", False, 0, 1), ev("cudaMemcpyAsync", False, 2, 3),
              ev("cudaGraphLaunch", False, 4, 5), ev("cudaStreamSynchronize", False, 6, 7),
              ev("cudaDeviceSynchronize", False, 8, 9), ev("aten::mm", False, 20, 30)]
    t = timeline.Trace(events=events, queries=2, window_s=50e-6, harness_syncs=1)
    assert timeline.union_us(events) == 30
    assert timeline.idle_share(t) == pytest.approx(0.4)
    assert timeline.launches_outside_graphs(t) == 1.0  # 2 launches over 2 queries
    assert timeline.host_syncs(t) == 0.5  # 2 syncs, the harness's own 1 left out
    assert timeline.device_ms(t, lambda n: n.startswith("k")) == pytest.approx(35e-3)
    assert timeline.idle_gaps(t, 0, 50) == [["aten::mm", 10e-6],
                                            ["host: outside any traced event", 10e-6]]
    assert timeline.top_device_ops(t)[0] == ["k2", 15e-6]
    # a collective's annotated range is no work of the device
    annotated = timeline.Trace(events=events + [ev("nccl:all_gather", True, 20, 30)],
                               queries=2, window_s=50e-6)
    assert timeline.busy_s(annotated) == timeline.busy_s(t)


def test_roofline_pct_needs_the_counter_to_agree():
    events = [ev("void (anonymous namespace)::jacobi_kernel<32>(...)", True, 0, 1000)] * 2
    t = timeline.Trace(events=events, queries=2, window_s=1e-3,
                       counters={"jacobi_window": 2}, batches={"jacobi_window": [(37, 32)]})
    pct = timeline.roofline_pct(t, "jacobi_window", counts.roofline_seconds)
    assert pct == pytest.approx(100 * counts.roofline_seconds([(37, 32)]) * 2 / 2e-3)
    t.counters["jacobi_window"] = 3
    with pytest.raises(RuntimeError, match="counter"):
        timeline.roofline_pct(t, "jacobi_window", counts.roofline_seconds)
    t.counters["jacobi_leaf"] = 0
    assert timeline.roofline_pct(t, "jacobi_leaf", counts.roofline_seconds) is None
