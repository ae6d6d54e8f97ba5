"""The harness finds a cell, a configuration, a network, an entry and a
per-layer metric by name; a new one of each is new files and new entries of
``BENCHMARK.json``; ``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import os
import re

import pytest

import harness
import tiny

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_every_cell_resolves_by_name(bench):
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.chips == w["chips"]
        assert cell.workload["why"] == w["why"]
        for metric in cell.per_layer:
            assert callable(cell.reader(metric["name"]).read)
        for fn in ("prepare", "reference", "compare", "instrument", "counters", "release"):
            assert callable(getattr(cell.entry, fn))
        assert cell.workload["limits"]
        checked = cell.checked(2 ** 31 + 11)
        assert len(checked) == cell.workload["check_answers"]
        assert min(checked) >= 2 and max(checked) < 2 + cell.workload["check_among"]


def test_checked_queries_and_batches_follow_the_seed(bench):
    import torch

    cell = harness.Cell("n512_spectrum", bench)
    assert cell.checked(5) == cell.checked(5)
    assert {tuple(cell.checked(s)) for s in range(20)} != {tuple(cell.checked(0))}
    batches = harness.Batches(cell.config, 2 ** 33 + 5, torch.device("cpu"))
    X, y = batches(7)
    assert X.shape == (512, 32, 32, 3) and y.shape == (512,) and int(y.max()) < 10
    assert torch.equal(X, batches(7)[0]) and not torch.equal(X, batches(8)[0])
    other = harness.Batches(cell.config, 2 ** 33 + 6, torch.device("cpu"))
    assert not torch.equal(X, other(7)[0])


def test_unknown_names_fail(bench, tmp_path):
    with pytest.raises(FileNotFoundError):
        harness.Cell("no_such_cell", bench)
    with pytest.raises(FileNotFoundError):
        harness.load_module(BENCH, "metrics", "no_such_metric")


def test_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in bench[k]}) == len(bench[k])
    assert len({m["name"] for m in bench["end_to_end"] + bench["per_layer"]}) == \
        len(bench["end_to_end"]) + len(bench["per_layer"])
    cells = {w["name"]: w for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(CHECKOUT, c["file"]))
        assert c["reduced"] == []
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= set(cells)
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name'].split('.')[0]}.py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for name in cells:  # every cell reports set-up, another end-to-end and a per-layer metric
        cell = harness.Cell(name, bench)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
        assert all(m["moves"] in got for m in cell.per_layer)
    assert os.path.getsize(os.path.join(CHECKOUT, "BENCHMARK.json")) <= 64 * 1024


def test_a_new_cell_config_and_metric_are_files_only(tmp_path):
    """A tiny configuration, a cell on it, its own end-to-end metric and a
    per-layer metric moving it, added to a copy of the benchmark as new files
    and new entries of BENCHMARK.json, run on the CPU with nothing else
    changed.  A dotted name is its base's quantity under a name of its own."""
    root = tiny.make_tree(str(tmp_path))
    with open(os.path.join(root, "metrics", "queries_traced.py"), "w") as fh:
        fh.write("def read(trace):\n    return float(trace.queries)\n")
    path = os.path.join(os.path.dirname(root), "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["end_to_end"].append({"name": "query_ms.tiny", "unit": "ms", "better": "lower",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["tiny_spectrum"]})
    bench["per_layer"].append({"name": "queries_traced.tiny", "unit": "queries",
                               "better": "higher", "source": "program_counter",
                               "layer": "harness", "moves": "query_ms.tiny",
                               "workloads": ["tiny_spectrum"]})
    with open(path, "w") as fh:
        json.dump(bench, fh)
    res, proc = tiny.run_cpu(root, "tiny_spectrum", trace=1)
    assert res is not None, proc.stderr[-4000:]
    assert res["correct"] is True
    assert res["metrics"]["queries_traced.tiny"]["value"] == tiny.TINY_CELLS["tiny_spectrum"][
        "trace_queries"]
    assert res["metrics"]["query_p99_ms"]["value"] >= res["metrics"]["query_median_ms"]["value"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert list(res)[-1] == "checks"
    res, proc = tiny.run_cpu(root, "tiny_spectrum", trace=0)
    assert set(res["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert res["info"]["checked_queries"] == harness.Cell(
        "tiny_spectrum", bench, root).checked(3)
    assert res["attempted"] >= 1 and res["metrics"]["query_ms"]["value"] > 0
    assert res["metrics"]["query_ms.tiny"] == res["metrics"]["query_ms"]


def test_run_refuses_without_a_card(tmp_path):
    """``run.py`` prints no result and exits non-zero where CUDA is absent."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                           "n512_spectrum", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=CHECKOUT, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
