"""The per-layer metrics that read the program's spans
(``vivit_tpu_torch.utils.trace``, read by :mod:`spans`).

On the CPU: a tiny cell whose Gram takes ``eigh_dc``'s chain path reports
every one of them in a traced run; a program without the recorder reports
none of them, and every other metric as before.  On the card (``-m card``,
``-s`` prints the split by stage): ``n512_spectrum``'s launches and host
waits the same with the spans recording and without, its idle within half
a point, its stages summing to its query time within 3%, and an N=128
call captured and replayed with the spans recording, replays timed whole.
"""

import json
import os
import statistics
import time
import warnings

import pytest

import harness
import tiny

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PLANTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "plants_spans.py")
# the metrics that read spans, by the span each reads
SPAN_METRICS = {"vtransform_ms": "vtransform", "gram_ms": "gram",
                "dc_basis_ms": "eigh_dc.basis", "dc_polish_ms": "eigh_dc.polish",
                "dc_leaves_ms": "leaves", "eigensolve_idle_ms": "eigensolve"}
# the tiny network at a Gram of 9 x 24 = 216 columns, past the direct solve
CHAIN_CELL = "tiny_chain_spectrum"
# the stages whose device times make up a query
STAGES = ("vtransform", "gram", "eigh_dc.basis", "eigh_dc.polish", "eigh_dc.guard",
          "eigh_dc.rerun")
# the metrics whose readings on the CPU do not depend on the clock
STEADY = ("launches_outside_graphs", "host_syncs", "guard_trip_pct")


def _chain_tree(tmp):
    """The tiny tree with :data:`CHAIN_CELL` added as files and entries."""
    root = tiny.make_tree(tmp)
    config = dict(tiny.TINY_CONFIG, name="tiny_chain_cnn", num_classes=10, batch=24)
    with open(os.path.join(root, "configs", "tiny_chain_cnn.json"), "w") as fh:
        json.dump(config, fh)
    cell = dict(tiny.TINY_CELLS["tiny_spectrum"], config="tiny_chain_cnn")
    with open(os.path.join(root, "workloads", f"{CHAIN_CELL}.json"), "w") as fh:
        json.dump(cell, fh)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "tiny_chain_cnn", "source": "tests", "reduced": [],
                             "file": "benchmark/configs/tiny_chain_cnn.json", "why": "tests"})
    bench["workloads"].append({"name": CHAIN_CELL, "config": "tiny_chain_cnn",
                               "traffic": CHAIN_CELL, "chips": 1, "why": "tests"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"].append(CHAIN_CELL)
    with open(path, "w") as fh:
        json.dump(bench, fh)
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Traced runs of the chain cell, with the program as it is and with
    the recorder hidden."""
    root = _chain_tree(str(tmp_path_factory.mktemp("bench")))
    out = {}
    for plant in (None, "no_spans"):
        res, proc = tiny.run_cpu(root, CHAIN_CELL, trace=1,
                                 plant=plant and f"{PLANTS}:{plant}")
        assert res is not None, proc.stderr[-4000:]
        out[plant] = res
    return out


def test_the_traced_run_reports_every_span_metric(runs):
    metrics = runs[None]["metrics"]
    for name in SPAN_METRICS:
        assert metrics[name]["unit"] == "ms" and metrics[name]["value"] >= 0, name
    assert metrics["dc_basis_ms"]["value"] > 0 and metrics["dc_polish_ms"]["value"] > 0


def test_without_the_recorder_nothing_new_and_the_rest_as_before(runs):
    got, before = runs[None], runs["no_spans"]
    assert not set(SPAN_METRICS) & set(before["metrics"])
    assert set(got["metrics"]) - set(SPAN_METRICS) == set(before["metrics"])
    for name in STEADY:
        assert got["metrics"][name] == before["metrics"][name], name
    assert got["correct"] == before["correct"] and got["checks"] == before["checks"]


def _n512(card, seed):
    """``n512_spectrum``'s cell, query and batches on the card, warmed up."""
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as fh:
        cell = harness.Cell("n512_spectrum", json.load(fh))
    recorder = harness.Recorder()
    cell.entry.instrument(recorder)
    model, batches = harness.make_inputs(cell, seed, card)
    query = cell.entry.prepare(harness.Context(cell, card, 0, 1, model, batches))
    for q in range(2):
        query(*batches(q))
    harness._sync(card)
    return cell, recorder, query, batches


@pytest.mark.card
def test_n512_spans_on_the_card(card):
    """Recording alone (no profiler): each query's stages sum to its host
    latency within 3%, and the trip counter counts the guard's warnings.
    Under the profiler, after a first profiled block, the same batches with
    recording off and on in turns, four blocks each: the same launches and
    host waits, mean idle within half a point (one block's idle varies by
    about two points), and the stages summing to the block's time within
    3%."""
    import spans
    import timeline
    from vivit_tpu_torch import eigdc
    from vivit_tpu_torch.utils import trace

    seed = 2 ** 31 + 1501
    cell, recorder, query, batches = _n512(card, seed)
    q0, count = 2, cell.workload["trace_queries"]
    lat, sums, trips = [], [], eigdc.TRIPS
    trace.enable(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for q in range(q0, q0 + count):
                ts = time.perf_counter()
                query(*batches(q))
                harness._sync(card)
                lat.append(1e3 * (time.perf_counter() - ts))
                recs = trace.collect()
                sums.append(sum(r.device_ms for r in recs if r.name in STAGES))
                print(f"\nquery {q}, recording alone: latency {lat[-1]:.3f} ms; stages (ms) "
                      + ", ".join(f"{r.name} {r.device_ms:.3f}" for r in recs
                                  if r.name in STAGES))
        # the process's first profiled block pays the profiler's start; then
        # recording off and on in turns (ABBA), on the same batches
        trace.enable(False)
        harness._traced_block(cell, query, recorder, batches, q0, card)
        blocks = {False: [], True: []}
        for on in (False, True, True, False, False, True, True, False):
            trace.enable(None if on else False)
            blocks[on].append(harness._traced_block(cell, query, recorder, batches, q0, card))
        off, on = blocks[False][-1], blocks[True][-1]
    finally:
        trace.enable(None)
    warned = sum("guard tripped" in str(w.message) for w in caught)
    print(f"trips counted {eigdc.TRIPS - trips}, warned {warned}")
    print("stages summed (ms):", [round(x, 3) for x in sums])
    print("stage: device ms, idle ms, host waits per query (profiled, recording on)")
    for name, (ms, idle, waits) in spans.split(on).items():
        print(f"  {name}: {ms:.3f}, {idle:.3f}, {waits:.2f}")
    for label, t in [("off", t) for t in blocks[False]] + [("on", t) for t in blocks[True]]:
        print(f"profiled, recording {label}: launches {timeline.launches_outside_graphs(t)}, "
              f"syncs {timeline.host_syncs(t)}, idle {100 * timeline.idle_share(t):.3f}%, "
              f"{1e3 * t.window_s / count:.3f} ms a query, "
              f"gaps {timeline.idle_gaps(t, *t.bounds_us)[:4]}")
    extra = {}
    for e in on.events:
        extra[e.name] = extra.get(e.name, 0) + 1
    for e in off.events:
        extra[e.name] = extra.get(e.name, 0) - 1
    print("host calls the recording adds a query:",
          {k: v / count for k, v in extra.items() if v >= count})
    idle = {k: statistics.mean(timeline.idle_share(t) for t in blocks[k]) for k in blocks}
    print(f"idle, mean of four blocks: off {100 * idle[False]:.3f}%, on {100 * idle[True]:.3f}%")
    assert eigdc.TRIPS - trips == warned
    assert abs(statistics.median(s / t for s, t in zip(sums, lat)) - 1) < 0.03
    assert spans.records(off) == []
    assert timeline.launches_outside_graphs(on) == timeline.launches_outside_graphs(off)
    assert timeline.host_syncs(on) == timeline.host_syncs(off)
    assert ({e.name for e in timeline.device_events(on.events)}
            == {e.name for e in timeline.device_events(off.events)})
    assert abs(idle[True] - idle[False]) < 0.005
    recs = spans.records(on)
    calls = sorted({r.call for r in recs})
    assert len(calls) == count
    per_call = [sum(r.device_ms for r in recs if r.call == c and r.name in STAGES)
                for c in calls]
    print("profiled, stages summed per call (ms):", [round(x, 3) for x in per_call])
    assert abs(sum(per_call) / (1e3 * on.window_s) - 1) < 0.03


@pytest.mark.card
def test_n128_captures_and_replays_with_spans_on(card):
    """An N=128 call captures and replays with recording on: inside the
    capture and the replays nothing records but the call's own span (a
    trip's eager rerun records its stages), and a replay gives the same
    bits with recording off."""
    import torch

    import program
    from vivit_tpu_torch.utils import graphs, trace
    import vivit_tpu_torch as vtt

    config = harness.load_json(harness.ROOT, "configs", "c10_3c3d_n128")
    network = harness.load_module(harness.ROOT, "networks", config["network"])
    gen = torch.Generator(device=card)
    gen.manual_seed(2 ** 31 + 1502)
    model = network.build(config, card, gen)
    batches = harness.Batches(config, 2 ** 31 + 1502, card)
    kw = dict(config["settings"])
    loss = program.loss(config)
    graphs.clear()
    trace.enable(True)
    trace.collect()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # replays bit for bit
    try:
        outs = [vtt.eigvalsh_structured(model, loss, *batches(q), device=card, **kw)[0]
                for q in range(3)]
        torch.cuda.synchronize(card)
        recs = trace.collect()
        assert len(graphs.entries()) == 1
        trace.enable(False)
        again = vtt.eigvalsh_structured(model, loss, *batches(2), device=card, **kw)[0]
    finally:
        torch.backends.cudnn.deterministic = deterministic
        trace.enable(None)
        graphs.clear()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["eigvalsh_structured"] * 3
    for r in roots[1:]:  # a replay runs no Python of its body: timed whole
        assert [x.name for x in recs if x.call == r.call] == ["eigvalsh_structured"] \
            or any(x.name == "eigh_dc.rerun" for x in recs if x.call == r.call)
        assert r.device_ms > 0
    print("\nN=128 root spans (ms):", [round(r.device_ms, 3) for r in roots])
    assert torch.equal(outs[2], again)
