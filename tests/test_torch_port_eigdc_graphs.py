"""What can be held on the CPU of ``eigh_dc``'s captured execution
(``vivit_tpu_torch.utils.graphs``): a CUDA graph holds no host read, so the
chain-path solve (:func:`vivit_tpu_torch.eigdc._solve`) must make none
between its vendor solves; the boundaries between its segments are those
vendor solves; and the cache key holds what shapes the solve and nothing
else.  The capture and replay themselves need the card (``chip_smoke.py``);
here every solve runs eagerly, inside a ``graphs.Segments`` that tracks the
split.
"""

import numpy as np
import pytest
import torch

from vivit_tpu_torch import eigdc
from vivit_tpu_torch.kernels.jacobi_cuda import KERNEL_SIZES
from vivit_tpu_torch.utils import graphs

# the Tensor methods that read a value to the host
HOST_READS = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist", "cpu",
              "numpy", "__array__")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ggn_like(n, seed=3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.exp(-np.linspace(0, 11, n)) * 250.0 + 1e-7
    return torch.tensor(((Q * lam) @ Q.T).astype(np.float32))


def _in_segments(monkeypatch, seg):
    """Run every eigdc solve on the CPU inside ``seg``."""
    solve = eigdc._solve_eager
    monkeypatch.setattr(eigdc, "_solve_eager", lambda *args: seg(solve, *args))


def _trap_host_reads(monkeypatch, seg):
    """Make every host read of a tensor raise while a segment of ``seg``
    runs."""
    for name in HOST_READS:
        original = getattr(torch.Tensor, name)

        def read(self, *args, _name=name, _original=original, **kwargs):
            if seg.open:
                raise AssertionError(f"Tensor.{_name} inside a segment")
            return _original(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, read)


def test_the_trap_catches_a_host_read(monkeypatch):
    """A body that reads a value between its vendor solves raises."""
    seg = graphs.Segments()
    _trap_host_reads(monkeypatch, seg)
    x = torch.ones(3)

    def body():
        y = graphs.eager(torch.linalg.eigh, torch.eye(2)[None])
        return bool(x.sum() > 0), y

    with pytest.raises(AssertionError, match="__bool__ inside a segment"):
        seg(body)
    assert bool(x.sum() > 0) and not seg.open


CASES = [(384, False, {}), (384, True, {}), (512, False, {}), (512, True, {}),
         (512, False, {"ladder": False}), (512, True, {"ladder": False}),
         (512, False, {"strip": 1024})]


@pytest.mark.parametrize("n,vectors,kw", CASES, ids=[
    f"{n}-{'eigenpairs' if v else 'eigenvalues'}-" + ",".join(f"{k}={x}" for k, x in kw.items())
    for n, v, kw in CASES])
def test_no_host_read_inside_a_segment(monkeypatch, n, vectors, kw):
    """The chain solve reads nothing to the host between its vendor solves;
    the guard's one read comes after the last segment."""
    seg = graphs.Segments()
    _in_segments(monkeypatch, seg)
    _trap_host_reads(monkeypatch, seg)
    ev, V, info = eigdc.eigh_dc(_ggn_like(n), eigenvectors=vectors, return_info=True, **kw)
    assert seg.steps and not seg.open
    assert not bool(info["tripped"])
    assert (V is not None) == vectors


@pytest.mark.parametrize("n,vectors,kw,shapes", [
    (384, False, {}, [(4, 150, 150), (1, 96, 96)]),
    (512, True, {}, [(1, 200, 200), (6, 125, 125), (1, 320, 320)]),
    (512, False, {"ladder": False},
     [(1, 200, 200), (2, 125, 125), (4, 125, 125), (1, 96, 96)]),
], ids=["384-eigenvalues", "512-eigenpairs", "512-eigenvalues-ladder=False"])
def test_segment_boundaries_are_the_vendor_solves(monkeypatch, n, vectors, kw, shapes):
    """Each boundary is one ``torch.linalg.eigh`` of the solve, with its
    shape, in call order: the ladder's (or the recursion's) exact leaves and
    zoom tail, and the bottom block; the Jacobi windows stay inside the
    segments.  The segmented solve gives the plain solve's result."""
    H = _ggn_like(n)
    plain = eigdc.eigh_dc(H, eigenvectors=vectors, **kw)
    vendor, eigh = [], torch.linalg.eigh

    def recorded(A):
        vendor.append(tuple(A.shape))
        return eigh(A)

    seg = graphs.Segments()
    _in_segments(monkeypatch, seg)
    monkeypatch.setattr(torch.linalg, "eigh", recorded)
    out = eigdc.eigh_dc(H, eigenvectors=vectors, **kw)
    assert [tuple(st.args[0].shape) for st in seg.steps] == vendor == shapes
    assert all(st.fn is recorded for st in seg.steps)
    assert all(s[-1] not in KERNEL_SIZES for s in shapes)
    for got, want in zip(out, plain):
        assert (got is None and want is None) or torch.equal(got, want)


def _keys(monkeypatch, calls):
    """The graph keys of ``calls`` (each a function of ``H``), taken on the
    CPU through ``_solve_captured`` with ``graphs.run`` running the body
    eagerly."""
    keys = []

    def run(key, fn, inputs, seed):
        keys.append(key)
        gen = torch.Generator()
        gen.manual_seed(seed)
        return fn(gen, *inputs)

    monkeypatch.setattr(graphs, "run", run)
    monkeypatch.setattr(eigdc, "_solve_eager", eigdc._solve_captured)
    for call in calls:
        call()
    return keys


def test_cache_key_holds_the_solves_shape(monkeypatch):
    """One key per ``n``, mode, resolved knob and guard on/off; the seed
    (``key``) and the guard's threshold are left out."""
    H, H2 = _ggn_like(192), _ggn_like(224)
    base, same_seed5, same_guard, other_n, other_mode, other_knob, unguarded = _keys(
        monkeypatch, [
            lambda: eigdc.eigh_dc(H, eigenvectors=False),
            lambda: eigdc.eigh_dc(H, eigenvectors=False, key=5),
            lambda: eigdc.eigh_dc(H, eigenvectors=False, guard=1e-3, return_info=True),
            lambda: eigdc.eigh_dc(H2, eigenvectors=False),
            lambda: eigdc.eigh_dc(H, eigenvectors=True),
            lambda: eigdc.eigh_dc(H, eigenvectors=False, kpm_degree=32),
            lambda: eigdc.eigh_dc(H, eigenvectors=False, guard=None),
        ])
    assert base == same_seed5 == same_guard
    assert len({base, other_n, other_mode, other_knob, unguarded}) == 5
    # a knob passed at its resolved default is the same solve
    assert _keys(monkeypatch, [lambda: eigdc.eigh_dc(H, eigenvectors=False,
                                                     tail_merge=True, bottom=96)]) == [base]


class _Stub:
    """An entry as ``graphs.run`` sees it, capturing and replaying nothing."""

    def __init__(self, fn, inputs, seed):
        self.seeds = [seed]
        self.outputs = (inputs[0] + 1.0, None)

    def replay(self, inputs, seed):
        self.seeds.append(seed)
        return self.outputs


def test_run_captures_once_per_key_and_clones(monkeypatch):
    """Same key, same entry (one capture, then replays with each call's
    seed); another key, another entry; every result is a clone of the
    static outputs."""
    monkeypatch.setattr(graphs, "_CACHE", {})
    monkeypatch.setattr(graphs, "_capture", _Stub)
    x = torch.zeros(3)
    a = graphs.run(("k", 1), None, (x,), 0)
    b = graphs.run(("k", 1), None, (x,), 7)
    c = graphs.run(("k", 2), None, (x,), 0)
    entries = graphs.entries()
    assert list(entries) == [("k", 1), ("k", 2)]
    assert entries[("k", 1)].seeds == [0, 7]
    static = entries[("k", 1)].outputs[0]
    assert a[1] is None and torch.equal(a[0], static)
    assert a[0] is not static and b[0] is not static and c[0] is not entries[("k", 2)].outputs[0]
