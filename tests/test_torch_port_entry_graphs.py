"""What can be held on the CPU of the entry points' captured execution
(``vivit_tpu_torch.utils.graphs.stage``): on the card each call of an entry
point (``eigvalsh_structured``, ``eigvalsh``, ``eigh_topk``,
``directional_derivatives_topk``, ``newton_step_topk`` and the four
computation classes) runs as CUDA graphs captured on its first call per
key.  A graph holds no host read and no host-to-device copy, so the body
of every entry must make none between its eager steps; the steps must be
the vendor eighs and LOBPCG's whole call, in order; a nested ``eigh_dc``
must join the entry's body, its draws seeded as an eager call's, its guard
read after the body; the key must hold what shapes the call; and the route
rule must send Monte-Carlo factors, strip-path Grams and CPU tensors to the
eager route.

The capture itself needs the card (``chip_smoke.py``, phase 16).  Here
``graphs._capture`` is replaced by :class:`_Tracked`, which runs the body
once inside a ``graphs.Segments`` that tracks the split, and the route rule
by one that captures on the CPU.
"""

import functools
import gc
import sys
import weakref

import numpy as np
import pytest
import torch
from torch import nn

import vivit_tpu_torch as vtt
from vivit_tpu_torch import eig, eigdc
from vivit_tpu_torch.engines import forward_fn, module_params
from vivit_tpu_torch.utils import graphs

# the Tensor methods that read a value to the host
HOST_READS = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist", "cpu",
              "numpy", "__array__")
# the functions that copy host memory to a device
HOST_COPIES = ("as_tensor", "tensor", "from_numpy")
N, K = 8, 4
HEAD = dict(precision="highest", gram_precision="bf16", deflate_ce_null=True)
# the degraded keywords of tests/test_guard_info.py: the guard must trip
FORCED_TRIP = dict(sign_iters_root=(1, 1), sign_iters=(1, 1), orth_iters=(1, 1),
                   ns_global=0, dm_iters=(0, 0, 0), kpm_degree=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Net(nn.Module):
    """A conv layer and a dense layer (ConvVT and DenseFactor blocks)."""

    def __init__(self, classes):
        super().__init__()
        self.conv = nn.Conv2d(2, 3, 3)
        self.fc = nn.Linear(48, classes)

    def forward(self, x):
        return self.fc(torch.relu(self.conv(x)).flatten(1))


def _problem(classes=10, seed=0):
    """``(module, X, y)``: the net with weights and an NCHW batch of ``N``
    from ``seed``."""
    torch.manual_seed(seed)
    module = Net(classes).eval()
    rng = np.random.default_rng(seed)
    X = torch.tensor(rng.normal(size=(N, 2, 6, 6)).astype(np.float32))
    y = torch.tensor(rng.integers(0, classes, size=(N,)))
    return module, X, y


def _model(form, module):
    """``(model, params)`` of one model form."""
    if form == "module":
        return module, None
    return forward_fn(module), dict(module_params(module))


def _compute(comp, form, X, y, *args, params=None):
    return comp.compute(X, y, *args, **({} if form == "module" else {"params": params}))


def _groups(params_or_module, **extra):
    names = [n for n, _ in params_or_module.named_parameters()] \
        if isinstance(params_or_module, nn.Module) else list(params_or_module)
    return [{"params": names, "criterion": vtt.keep_top_k(K), **extra}]


LOSS = vtt.CrossEntropyLoss()
DAMPING = vtt.constant_damping(1.0)


def _call(name, form, model, params, X, y, module):
    """One call of the entry point ``name`` in one model form on the CPU."""
    kw = dict(device="cpu", **HEAD)
    p = {} if form == "module" else {"params": params}
    if name == "eigvalsh_structured":
        return vtt.eigvalsh_structured(model, LOSS, X, y, eig_backend="dc",
                                       return_eig_info=True, **kw)
    if name == "eigvalsh":
        return vtt.eigvalsh(model, LOSS, X, y, eig_backend="dc", **p, **kw)
    if name == "eigh_topk":
        return vtt.eigh_topk(model, LOSS, X, y, K, solver="dc", **p, **kw)
    if name == "directional_derivatives_topk":
        return vtt.directional_derivatives_topk(model, LOSS, X, y, K, solver="dc", **p, **kw)
    if name.startswith("newton_step"):
        solver = name.split("-")[1]
        if form == "module":
            return vtt.newton_step_structured(model, LOSS, X, y, K, 1.0, solver=solver, **kw)
        return vtt.newton_step_topk(model, LOSS, X, y, K, 1.0, solver=solver, **p, **kw)
    owner = module if form == "module" else params
    settings = dict(eig_backend="dc", **kw)
    if name == "EigvalshComputation":
        return _compute(vtt.EigvalshComputation(model, LOSS, **settings), form, X, y,
                        params=params)
    cls = getattr(vtt, name)
    extra = {"damping": DAMPING} if name == "DirectionalDampedNewtonComputation" else {}
    return _compute(cls(model, LOSS, **settings), form, X, y, _groups(owner, **extra),
                    params=params)


CLASSES = ("EigvalshComputation", "EighComputation", "DirectionalDerivativesComputation",
           "DirectionalDampedNewtonComputation")
ENTRIES = ([("eigvalsh_structured", "module"), ("eigvalsh", "function")]
           + [(name, form) for name in ("eigh_topk", "directional_derivatives_topk",
                                         "newton_step-dc", "newton_step-lobpcg", *CLASSES)
              for form in ("module", "function")])
IDS = [f"{name}-{form}" for name, form in ENTRIES]


class _Tracked:
    """An entry as ``graphs.stage`` sees it: its body runs once per call
    inside a tracking ``graphs.Segments``, as the capture and each replay
    would run it on the card (:attr:`runs` gets each run's Segments)."""

    runs = []

    def __init__(self, fn, inputs, seed):
        self.fn = fn
        self.outputs = self.replay(inputs, seed)

    def replay(self, inputs, seed):
        seg = graphs.Segments()
        self.runs.append(seg)
        self.guards = seg.guards
        gen = torch.Generator()
        gen.manual_seed(seed)
        self.outputs = seg(self.fn, gen, *(x.clone() for x in inputs))
        return self.outputs

    tripped = graphs.Entry.tripped


@pytest.fixture()
def tracked(monkeypatch):
    """Every entry point call takes the captured route on the CPU, each run
    of its body tracked (the yielded list gets each run's Segments)."""
    monkeypatch.setattr(graphs, "_CACHE", {})
    monkeypatch.setattr(graphs, "_capture", _Tracked)
    monkeypatch.setattr(_Tracked, "runs", [])
    monkeypatch.setattr(graphs, "captured", lambda X, mc, solver, side: mc == 0)
    return _Tracked.runs


def _eagerly(monkeypatch, fn):
    """``fn()`` on the eager route (the route rule says no)."""
    with monkeypatch.context() as m:
        m.setattr(graphs, "captured", lambda X, mc, solver, side: False)
        return fn()


def _trap(monkeypatch):
    """Make every host read of a tensor and every copy between devices
    raise while a segment of a body runs."""
    def trapped(original, name):
        def call(*args, **kwargs):
            if graphs._running() is not None:
                raise AssertionError(f"{name} inside a segment")
            return original(*args, **kwargs)
        return call

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name,
                            trapped(getattr(torch.Tensor, name), f"Tensor.{name}"))
    for name in HOST_COPIES:
        monkeypatch.setattr(torch, name, trapped(getattr(torch, name), f"torch.{name}"))
    to = torch.Tensor.to

    def moved(self, *args, **kwargs):
        devices = [kwargs.get("device")] + [a for a in args if isinstance(a, (str, torch.device))]
        if graphs._running() is not None and any(
                d is not None and torch.device(d) != self.device for d in devices):
            raise AssertionError("Tensor.to(device) inside a segment")
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", moved)
    setitem = torch.Tensor.__setitem__

    def written(self, index, value):
        # a Python number written into a CUDA tensor is a host-to-device copy;
        # the Jacobi kernel's plain version, which only a CPU tensor runs,
        # is not a card's body
        if (graphs._running() is not None and not isinstance(value, torch.Tensor)
                and not sys._getframe(1).f_code.co_filename.endswith("jacobi_cuda.py")):
            raise AssertionError("a number written into a tensor inside a segment")
        return setitem(self, index, value)

    monkeypatch.setattr(torch.Tensor, "__setitem__", written)


def _flat(out):
    """The tensors of a nested result, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _flat(x)]
    return []


def _assert_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want) and got
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_the_traps_catch_host_reads_and_copies(monkeypatch):
    """A body that reads a value or copies from the host inside a segment
    raises; a :func:`graphs.constant` made of the same copy does not."""
    _trap(monkeypatch)
    x = torch.ones(3)
    seg = graphs.Segments()
    with pytest.raises(AssertionError, match="__bool__ inside a segment"):
        seg(lambda: bool(x.sum() > 0))
    with pytest.raises(AssertionError, match="torch.as_tensor inside a segment"):
        seg(lambda: torch.as_tensor([1, 2]))
    with pytest.raises(AssertionError, match=r"Tensor.to\(device\) inside a segment"):
        seg(lambda: x.to("meta"))
    with pytest.raises(AssertionError, match="a number written into a tensor"):
        seg(lambda: x.__setitem__(0, 1.0))
    idx = seg(lambda: graphs.constant(lambda: torch.as_tensor([1, 2])))
    assert torch.equal(idx, torch.tensor([1, 2])) and seg.constants == [idx]
    assert bool(x.sum() > 0) and not seg.open


@pytest.mark.parametrize("name,form", ENTRIES, ids=IDS)
def test_no_host_read_inside_an_entry_body(monkeypatch, tracked, name, form):
    """Every entry point's body, in both model forms, reads nothing to the
    host and copies nothing from it inside a segment (the classes' host
    criterion runs after their one program), and gives the eager route's
    result bit for bit."""
    module, X, y = _problem()
    model, params = _model(form, module)
    want = _eagerly(monkeypatch, lambda: _call(name, form, model, params, X, y, module))
    assert not graphs._CACHE and not tracked
    _trap(monkeypatch)
    got = _call(name, form, model, params, X, y, module)
    assert len(tracked) == len(graphs._CACHE) == 1
    assert all(not seg.open for seg in tracked)
    _assert_equal(got, want)


def test_subsampling_index_is_a_constant(monkeypatch, tracked):
    """The ``subsampling`` index is made once, outside the segments, and a
    replay reads the same tensor."""
    module, X, y = _problem()
    _trap(monkeypatch)
    want = vtt.eigh_topk(module, LOSS, X, y, K, solver="dc", subsampling=[1, 4, 6, 7],
                         device="cpu", **HEAD)
    assert [c.tolist() for seg in tracked for c in seg.constants] == [[1, 4, 6, 7]] * 2
    got = vtt.eigh_topk(module, LOSS, X, y, K, solver="dc", subsampling=[1, 4, 6, 7],
                        device="cpu", **HEAD)
    assert len(graphs._CACHE) == 1 and len(tracked) == 2
    _assert_equal(got, want)


def _recording(monkeypatch):
    """Record every vendor eigh and LOBPCG call: ``[(fn name, shape)]``."""
    calls, depth = [], [0]

    def recorder(fn, name):
        @functools.wraps(fn)
        def call(A, *args):
            if not depth[0]:  # not LOBPCG's own small eighs
                calls.append((name, tuple(A.shape)))
            depth[0] += 1
            try:
                return fn(A, *args)
            finally:
                depth[0] -= 1
        return call

    for name in ("eigh", "eigvalsh"):
        monkeypatch.setattr(torch.linalg, name, recorder(getattr(torch.linalg, name), name))
    monkeypatch.setattr(eig, "_lobpcg_topk", recorder(eig._lobpcg_topk, "lobpcg"))
    return calls


@pytest.mark.parametrize("name,form,steps", [
    ("eigvalsh_structured", "module", [[("eigvalsh", (72, 72))]]),
    ("eigh_topk", "function", [[("eigh", (72, 72))]]),
    ("newton_step-lobpcg", "module", [[("lobpcg", (72, 72))]]),
    ("EighComputation", "module", [[("eigh", (72, 72))]]),
    ("DirectionalDampedNewtonComputation", "function", [[("eigh", (72, 72))]]),
], ids=["eigvalsh_structured", "eigh_topk-function", "newton_step-lobpcg",
        "EighComputation", "DirectionalDampedNewtonComputation-function"])
def test_segment_boundaries_are_the_vendor_steps(monkeypatch, tracked, name, form, steps):
    """Each program's eager steps are its vendor eighs (the solves of the
    Grams at or below ``eigh_dc``'s leaf size) and LOBPCG's whole call, with
    their shapes, in call order; a class's eager rest after its program
    (criteria, back-projection, steps) calls none."""
    module, X, y = _problem()
    model, params = _model(form, module)
    calls = _recording(monkeypatch)
    _call(name, form, model, params, X, y, module)
    got = [[(st.fn.__name__ if st.fn.__name__ != "_lobpcg_topk" else "lobpcg",
             tuple(st.args[0].shape)) for st in seg.steps] for seg in tracked]
    got = [[(n.replace("linalg_", ""), s) for n, s in prog] for prog in got]
    assert got == steps
    assert [c for prog in got for c in prog] == calls


@pytest.mark.parametrize("form", ["module", "function"])
def test_chain_solves_join_the_body_and_draw_as_eager(monkeypatch, tracked, form):
    """With two groups whose Grams (248²) take ``eigh_dc``'s chain path, the
    solves run inside the entry's body through ``graphs.run`` (as on the
    card), open no cache entry of their own, add their vendor steps to the
    body's in order, draw from a generator each, seeded as an eager call
    seeds it, and hand their guards to the entry; the result is the eager
    call's, bit for bit."""
    module, X, y = _problem(classes=32)
    model, params = _model(form, module)
    groups = [{"params": ["conv.weight", "conv.bias"], "criterion": vtt.keep_top_k(K)},
              {"params": ["fc.weight", "fc.bias"], "criterion": vtt.keep_top_k(K)}]
    comp = vtt.EighComputation(model, LOSS, eig_backend="dc", device="cpu", **HEAD)
    want = _eagerly(monkeypatch, lambda: _compute(comp, form, X, y, groups, params=params))
    monkeypatch.setattr(eigdc, "_solve_eager", eigdc._solve_captured)
    calls = _recording(monkeypatch)
    _trap(monkeypatch)
    got = _compute(comp, form, X, y, groups, params=params)
    (stage1,) = tracked
    assert len(graphs._CACHE) == 1  # the class's program, no solve of its own
    assert stage1.seeds == [0, 0] and len(stage1.guards) == 2
    assert [("eigh", tuple(st.args[0].shape)) for st in stage1.steps] == calls
    assert len(calls) > 2
    _assert_equal(got, want)


def test_a_shared_generator_would_draw_otherwise(monkeypatch):
    """The control of the test above: the second solve of the same matrix
    drawing on from the first one's generator gives other bits than a solve
    from a fresh generator seeded as an eager call seeds it."""
    module, X, y = _problem(classes=32)
    vt = vtt.structured.structured_ggn_sqrt_vt(module, LOSS, X, y, deflate_ce_null=True)
    gram = vtt.structured.gram_matrix_mixed(vt)
    fresh = eigdc.eigvalsh_dc(gram, guard=None)
    shared = torch.Generator()
    shared.manual_seed(0)
    monkeypatch.setattr(graphs, "generator", lambda device, seed: shared)
    assert torch.equal(eigdc.eigvalsh_dc(gram, guard=None), fresh)
    assert not torch.equal(eigdc.eigvalsh_dc(gram, guard=None), fresh)


def test_a_tripped_guard_reruns_the_call_eagerly(monkeypatch, tracked):
    """A guard that trips inside the body warns nothing there; after the
    body the entry reads it and runs the call again eagerly, where the
    solve warns once and takes the vendor's result: the eager call's."""
    module, X, y = _problem(classes=32)
    monkeypatch.setattr(eigdc, "eigh_dc", functools.partial(eigdc.eigh_dc, **FORCED_TRIP))

    def call():
        return vtt.eigvalsh_structured(module, LOSS, X, y, eig_backend="dc",
                                       return_eig_info=True, device="cpu", **HEAD)

    with pytest.warns(UserWarning, match="guard tripped") as eager_warnings:
        want = _eagerly(monkeypatch, call)
    assert len(eager_warnings) == 1 and not tracked
    with pytest.warns(UserWarning, match="guard tripped") as caught:
        got = call()
    assert len([w for w in caught if "guard tripped" in str(w.message)]) == 1
    (seg,) = tracked
    assert len(seg.guards) == 1 and bool(seg.guards[0])
    assert bool(got[1][0]["tripped"])
    _assert_equal(got, want)


@pytest.mark.parametrize("form", ["module", "function"])
def test_the_key_holds_what_shapes_the_call(monkeypatch, tracked, form):
    """Same key for a second call, after an in-place update of a parameter
    and on a new batch of the same shape.  A replaced parameter tensor keeps
    a model function's key (its ``params`` are static inputs, copied in)
    and gives a module a new key that drops the stale one (its graphs read
    its tensors in place).  A changed setting, another damping callable
    (``constant_damping`` by its value) or cuDNN's deterministic flag give
    a new key; every call gives the eager route's result."""
    module, X, y = _problem()
    model, params = _model(form, module)
    p = {} if form == "module" else {"params": params}

    def newton(damping=1.0, X=X, y=y, **kw):
        return vtt.newton_step_topk(model, LOSS, X, y, K, damping, solver="dc",
                                    device="cpu", **p, **{**HEAD, **kw})

    def checked(**kw):
        got = newton(**kw)
        _assert_equal(got, _eagerly(monkeypatch, lambda: newton(**kw)))
        return got

    first = checked()
    checked()
    with torch.no_grad():
        (params or dict(module.named_parameters()))["fc.weight"].mul_(0.5)
    updated = checked()
    assert len(graphs._CACHE) == 1
    assert not torch.equal(updated[-2], first[-2])
    _, X2, y2 = _problem(seed=1)
    checked(X=X2, y=y2)
    assert len(graphs._CACHE) == 1
    (before,) = graphs._CACHE
    if form == "module":
        module.fc.weight.data = module.fc.weight.data.clone()
    else:
        params["fc.weight"] = params["fc.weight"].clone() * 2
    checked()
    (after,) = graphs._CACHE
    assert (after == before) == (form == "function")
    checked(gram_precision=None)
    checked(damping=DAMPING)
    checked(damping=vtt.constant_damping(1.0))
    assert len(graphs._CACHE) == 3
    checked(damping=vtt.constant_damping(2.0))
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = not saved
    try:
        checked()
    finally:
        torch.backends.cudnn.deterministic = saved
    assert len(graphs._CACHE) == 5
    assert len({key[0][0] for key in graphs._CACHE}) == 1


@pytest.mark.parametrize("form", ["module", "function"])
def test_a_freed_callable_cannot_lend_its_key(monkeypatch, tracked, form):
    """A sweep of damping closures, each freed when its call returns (the
    next one may take its address), and of model functions rebuilt per
    call: every call gives its own eager result, the key holding each
    callable, so that no later one can take its identity."""
    module, X, y = _problem()
    model, params = _model(form, module)
    p = {} if form == "module" else {"params": params}

    def damped(lam):
        return lambda evals, evecs, gammas, lambdas: lam * torch.ones_like(evals)

    def newton(damping, model=model):
        return vtt.newton_step_topk(model, LOSS, X, y, K, damping, solver="dc",
                                    device="cpu", **p, **HEAD)

    for lam in (1.0, 4.0, 16.0):
        got = newton(damped(lam))
        _assert_equal(got, _eagerly(monkeypatch, lambda: newton(damped(lam))))
    assert len(graphs._CACHE) == 3
    if form == "function":
        for scale in (1.0, 3.0):
            def rebuilt(params, x, scale=scale):
                return scale * model(params, x)
            got = newton(1.0, model=rebuilt)
            _assert_equal(got, _eagerly(monkeypatch, lambda: newton(1.0, model=rebuilt)))
        assert len(graphs._CACHE) == 5


def test_the_key_holds_its_callables():
    """The key holds the model function and a damping callable, so that
    their ids cannot pass to a later object while it lives, and lets them
    go with it; ``constant_damping`` is keyed by its value."""
    module, X, y = _problem()
    model, params = _model("function", module)

    def key(fn, damping):
        return graphs.entry_key("newton_step_topk", fn, params, X, y, LOSS, damping=damping)

    def damped(lam):
        return lambda evals, evecs, gammas, lambdas: lam * torch.ones_like(evals)

    fn, damping = (lambda p, x: model(p, x)), damped(1.0)
    alive = [weakref.ref(fn), weakref.ref(damping)]
    first = key(fn, damping)
    del fn, damping
    gc.collect()
    assert all(ref() is not None for ref in alive)
    later = [key(lambda p, x: model(p, x), damped(lam)) for lam in (2.0, 3.0)]
    assert first not in later and later[0] != later[1]
    del first, later
    gc.collect()
    assert all(ref() is None for ref in alive)
    assert key(model, vtt.constant_damping(1.0)) == key(model, vtt.constant_damping(1.0))
    assert key(model, vtt.constant_damping(1.0)) != key(model, vtt.constant_damping(2.0))


def test_route_rule():
    """The rule alone: a CUDA call with exact factors is captured if its
    solver is not ``"dc"`` or its Gram is below 1536; Monte-Carlo factors,
    a strip-path Gram and a CPU tensor are not."""
    class Card:
        is_cuda = True

    assert graphs.captured(Card, 0, "dc", lambda: 1535)
    assert not graphs.captured(Card, 0, "dc", lambda: 1536)
    assert graphs.captured(Card, 0, "eigh", lambda: 4608)
    assert graphs.captured(Card, 0, "lobpcg", lambda: 4608)
    assert graphs.captured(Card, 0, "xla", lambda: 4608)
    assert not graphs.captured(Card, 1, "eigh", lambda: 72)
    assert not graphs.captured(torch.ones(1), 0, "eigh", lambda: 72)


@pytest.mark.parametrize("form", ["module", "function"])
def test_entries_ask_the_route_rule(monkeypatch, form):
    """Each call of a key without an entry asks the rule with its factors,
    its solver and its Gram's side ((C−1)·S deflated, C·S not, S the
    sub-sample); a CPU call, a Monte-Carlo call and a strip-path Gram take
    the eager route and open no entry."""
    monkeypatch.setattr(graphs, "_CACHE", {})
    asked, rule = [], graphs.captured

    def spy(X, mc, solver, side):
        asked.append((mc, solver, None if mc else side()))
        return rule(X, mc, solver, side)

    monkeypatch.setattr(graphs, "captured", spy)
    module, X, y = _problem()
    model, params = _model(form, module)
    p = {} if form == "module" else {"params": params}
    vtt.eigh_topk(model, LOSS, X, y, K, solver="dc", device="cpu", **p, **HEAD)
    vtt.eigh_topk(model, LOSS, X, y, K, solver="dc", device="cpu", **p, **HEAD)
    vtt.eigh_topk(model, LOSS, X, y, K, solver="eigh", subsampling=[0, 2, 4],
                  device="cpu", **p)
    vtt.eigh_topk(model, LOSS, X, y, K, solver="dc", mc_samples=2, key=0, device="cpu", **p)
    assert asked == [(0, "dc", 72), (0, "dc", 72), (0, "eigh", 30), (2, "dc", None)]
    assert not graphs._CACHE

    # the rule on a card: a strip-path Gram and Monte-Carlo factors go eager
    class Card:
        is_cuda = True

    wide, wide_params = _model("function", Net(200))
    assert graphs.gram_side(wide, wide_params, X, None, True) == 199 * N
    assert not rule(Card, 0, "dc", lambda: graphs.gram_side(wide, wide_params, X, None, True))
    assert not rule(Card, 2, "dc", lambda: 72)
