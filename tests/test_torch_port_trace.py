"""The span recorder (``vivit_tpu_torch.utils.trace``) and the guard's trip
counter (``eigdc.TRIPS``) on the CPU: what a call records with recording
off, on and under ``torch.profiler``; the records' calls, parents and
times; nothing recorded inside a graph body; the same results either way;
the ring's bound.  On the CPU a span's device time is its host interval.
"""

import warnings

import numpy as np
import pytest
import torch
from torch import nn

import vivit_tpu_torch as vtt
from vivit_tpu_torch import eigdc
from vivit_tpu_torch.utils import graphs, trace

N = 8
LOSS = vtt.CrossEntropyLoss()
HEAD = dict(precision="highest", gram_precision="bf16", deflate_ce_null=True,
            eig_backend="dc", device="cpu")
# the spans of one eigvalsh_structured call on the chain path, by parent
TREE = {"eigvalsh_structured": None, "vtransform": "eigvalsh_structured",
        "vtransform.forward": "vtransform", "vtransform.loss_hessian_sqrt": "vtransform",
        "vtransform.backward": "vtransform", "vtransform.reconstruct": "vtransform",
        "gram": "eigvalsh_structured", "eigensolve": "eigvalsh_structured",
        "eigh_dc.basis": "eigensolve", "eigh_dc.polish": "eigensolve",
        "eigh_dc.guard": "eigensolve"}


@pytest.fixture(autouse=True)
def _fresh():
    """One torch thread (the suite runs several workers); the recorder at
    its import state, empty, before and after each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.enable(None)
    trace.collect()
    yield
    trace.enable(None)
    trace.collect()
    torch.set_num_threads(threads)


class Net(nn.Module):
    """A conv layer and a dense layer (ConvVT and DenseFactor blocks)."""

    def __init__(self, classes):
        super().__init__()
        self.conv = nn.Conv2d(2, 3, 3)
        self.fc = nn.Linear(48, classes)

    def forward(self, x):
        return self.fc(torch.relu(self.conv(x)).flatten(1))


def _problem(classes=32, seed=0):
    """``(module, X, y)``; at 32 classes the deflated Gram (248²) takes
    ``eigh_dc``'s chain path, eagerly on the CPU."""
    torch.manual_seed(seed)
    module = Net(classes).eval()
    rng = np.random.default_rng(seed)
    X = torch.tensor(rng.normal(size=(N, 2, 6, 6)).astype(np.float32))
    y = torch.tensor(rng.integers(0, classes, size=(N,)))
    return module, X, y


def _call(module, X, y):
    return vtt.eigvalsh_structured(module, LOSS, X, y, **HEAD)


@pytest.mark.parametrize("state", [None, False])
def test_off_records_nothing(state):
    """At import (no profiler running) and after ``enable(False)`` a call
    records nothing."""
    trace.enable(state)
    _call(*_problem())
    assert trace.collect() == []


def test_a_call_records_its_stages():
    """Each call records the stages of :data:`TREE` under one call id of
    its own, every parent the enclosing stage; the leaves sit under the
    basis or the polish."""
    module, X, y = _problem()
    trace.enable(True)
    _call(module, X, y)
    _call(module, X, y)
    records = trace.collect()
    by_index = {r.index: r for r in records}
    calls = sorted({r.call for r in records})
    assert len(calls) == 2
    for call in calls:
        mine = [r for r in records if r.call == call]
        assert {r.name for r in mine} == set(TREE) | {"leaves"}
        for r in mine:
            parent = by_index[r.parent].name if r.parent is not None else None
            if r.name == "leaves":
                assert parent in ("eigh_dc.basis", "eigh_dc.polish")
            else:
                assert parent == TREE[r.name]
            if r.parent is not None:
                outer = by_index[r.parent]
                assert outer.start_us <= r.start_us <= r.end_us <= outer.end_us
        guard = [r for r in mine if r.name == "eigh_dc.guard"]
        assert len(guard) == 2  # the terms in the solve, the read after it
        assert sum(r.name == "eigvalsh_structured" for r in mine) == 1


def test_cpu_device_time_is_the_host_interval():
    trace.enable(True)
    _call(*_problem())
    records = trace.collect()
    assert records
    for r in records:
        assert r.device_ms == (r.end_us - r.start_us) / 1e3
        assert r.device_ms >= 0


def test_under_the_profiler():
    """At the import state a ``torch.profiler`` session turns recording on
    for its length; ``enable(False)`` keeps it off even then."""
    from torch.profiler import ProfilerActivity, profile

    module, X, y = _problem()
    with profile(activities=[ProfilerActivity.CPU]):
        _call(module, X, y)
    assert {r.name for r in trace.collect()} >= set(TREE)
    _call(module, X, y)
    assert trace.collect() == []
    trace.enable(False)
    with profile(activities=[ProfilerActivity.CPU]):
        _call(module, X, y)
    assert trace.collect() == []


def test_nothing_inside_a_graph_body():
    """A span inside a ``graphs.Segments`` body (a warm-up, a capture, a
    rerun) records nothing; the span around the body does."""
    trace.enable(True)

    def body(x):
        with trace.span("inner", x):
            return x + 1

    with trace.span("outer"):
        graphs.Segments()(body, torch.zeros(3))
    assert [r.name for r in trace.collect()] == ["outer"]


def test_results_are_the_same_either_way():
    module, X, y = _problem()
    trace.enable(False)
    off = _call(module, X, y)
    trace.enable(True)
    on = _call(module, X, y)
    assert trace.collect()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_a_forced_trip_counts_once():
    """A guard threshold near 0 trips: one warning, one more in
    ``eigdc.TRIPS``, and the vendor's solve timed as ``eigh_dc.rerun``;
    an untripped solve counts nothing."""
    module, X, y = _problem()
    vt = vtt.structured.structured_ggn_sqrt_vt(module, LOSS, X, y, deflate_ce_null=True)
    gram = vtt.structured.gram_matrix_mixed(vt)
    before = eigdc.TRIPS
    eigdc.eigvalsh_dc(gram)
    assert eigdc.TRIPS == before
    trace.enable(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = eigdc.eigvalsh_dc(gram, guard=1e-30)
    assert len([w for w in caught if "guard tripped" in str(w.message)]) == 1
    assert eigdc.TRIPS == before + 1
    assert [r.name for r in trace.collect()].count("eigh_dc.rerun") == 1
    assert torch.equal(got, torch.linalg.eigvalsh(0.5 * (gram + gram.T)))


def test_collect_drains_and_the_ring_counts_drops(monkeypatch):
    """``collect`` returns the finished records once, leaving an open span
    in the ring; past :data:`trace.LIMIT` the oldest go and
    :data:`trace.DROPPED` counts them."""
    trace.enable(True)
    with trace.span("open") as outer:
        with trace.span("a"):
            pass
        assert [r.name for r in trace.collect()] == ["a"]
        assert trace.collect() == []
    assert trace.collect() == [outer]
    monkeypatch.setattr(trace, "LIMIT", 4)
    dropped = trace.DROPPED
    for i in range(7):
        with trace.span(f"s{i}"):
            pass
    assert trace.DROPPED == dropped + 3
    assert [r.name for r in trace.collect()] == ["s3", "s4", "s5", "s6"]
