"""Captured execution: CUDA graphs of a function's device work, captured on
its first call per key and replayed on every later one.

The port's counterpart of ``jax.jit``'s compilation cache.  The JAX package
runs a call as one compiled XLA program; PyTorch runs it eagerly, one
launch per op, and on a loop of small ops the host's launch rate, not the
card, sets the time.  :func:`run` takes ``fn(gen, *inputs)``: device work
only, no host read, its random numbers drawn from ``gen``.  Work that
cannot be captured goes through :func:`eager`: a vendor solver that checks
its status on the host (``torch.linalg.eigh`` on CUDA reads cuSOLVER's
``info``) splits the capture there.  The graph so far ends, the step runs
eagerly on its static inputs, and the next graph begins; every replay runs
graph, step, graph, ... in that order.

Per key the cache holds an :class:`Entry`: its graphs, sharing one memory
pool; its eager steps with their static inputs and outputs; the static
inputs (copied in before each replay) and outputs (cloned out after it, so
that the next replay cannot overwrite what a caller holds); generators
registered with every graph and re-seeded before each replay, so that a
replay draws what an eager call with the same seeds draws; and the Jacobi
kernels' launches captured in each graph, which every replay adds to their
counters (``jacobi_cuda.LAUNCHES`` for the windows,
``jacobi_leaf_cuda.LAUNCHES`` for the leaves and edge blocks).

Bodies nest.  Inside a running body :func:`run` captures nothing of its
own: its ``fn`` runs inline, its draws from a generator of its own
(:func:`generator`, seeded as an eager call seeds it), its eager steps
become the outer body's, and it opens no cache entry.  Whole calls of the
package's entry points are captured this way (:func:`stage`, keyed by
:func:`entry_key`, routed by :func:`captured`): the V-transform, the Gram,
the chain-path solves and what follows them are one body.  What such a
body needs from the host it takes through :func:`constant`, made once
before the capture and held by the entry; a solve's guard hands its
verdict to :func:`guard`, read after the replay.

The first call per key runs ``fn`` eagerly once on a side stream, which
builds what is made at first use (the kernel's ``nvcc`` build and library,
its schedule tables, cuBLAS's and cuDNN's workspaces, the constants), then
captures it on that stream, replaying each graph as soon as it is captured
so that the next eager step reads computed inputs; its result is the
replays'.  It therefore launches every kernel twice.  A capture that fails
raises; nothing runs the eager body in its place.

Each entry keeps a memory pool at its call's peak.  An entry point's key
(:func:`entry_key`) holds a module's tensors' addresses, and a capture at
new addresses drops the entries of the same call at the old ones; beyond
that, like JAX's, the cache is unbounded, and :func:`clear`, the
counterpart of ``jax.clear_caches()``, releases every pool.  One capture
at a time, from one thread.
"""

import time

import torch

from vivit_tpu_torch.kernels import jacobi_cuda, jacobi_leaf_cuda

# the kernels' launch counters: a capture launches nothing, a replay adds
# what its graphs captured
_COUNTED = (jacobi_cuda, jacobi_leaf_cuda)
_CACHE = {}
_STREAMS = {}  # device -> the side stream of its warm-ups and captures
_ACTIVE = None  # the Segments running a body, if any


class Step:
    """An eager step between two segments: ``fn(*args)`` and its result."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out

    def rerun(self):
        """Run ``fn`` on the static inputs again, its result copied into
        the static outputs."""
        new = self.fn(*self.args)
        for static, value in zip(_tensors(self.out), _tensors(new)):
            static.copy_(value)


class Segments:
    """Runs a body split into segments at its :func:`eager` steps.

    On its own it only tracks the split: ``open`` is true while a segment
    runs; ``steps`` gets each eager step in order, ``seeds`` the seed of
    each nested body's generator, ``constants`` each :func:`constant` and
    ``guards`` each :func:`guard` (the CPU tests hold a body to them).
    :class:`_Capture` makes each segment a CUDA graph."""

    def __init__(self):
        self.open = False
        self.steps, self.seeds, self.constants, self.guards = [], [], [], []

    def begin(self):
        self.open = True

    def end(self):
        self.open = False

    def step(self, fn, args):
        self.end()
        out = fn(*args)
        self.steps.append(Step(fn, args, out))
        self.begin()
        return out

    def generator(self, device, seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.seeds.append(seed)
        return gen

    def constant(self, make):
        self.open = False
        try:
            value = make()
        finally:
            self.open = True
        self.constants.append(value)
        return value

    def __call__(self, fn, *args):
        """``fn(*args)`` as one run of segments; inside a running body,
        inline, as part of it."""
        global _ACTIVE
        if _ACTIVE is not None:
            return fn(*args)
        _ACTIVE = self
        try:
            self.begin()
            out = fn(*args)
            self.end()
        finally:
            self.open = False
            _ACTIVE = None
        return out


def _running():
    """The Segments whose segment is running, if any (``None`` inside an
    eager step too)."""
    return _ACTIVE if _ACTIVE is not None and _ACTIVE.open else None


def eager(fn, *args):
    """``fn(*args)``, run outside any graph: inside a capture it ends the
    current segment, and every replay runs it eagerly at this point."""
    active = _running()
    return fn(*args) if active is None else active.step(fn, args)


def generator(device, seed):
    """A generator on ``device`` seeded with ``seed``; inside a body, the
    one of this draw site, registered with the body's graphs and re-seeded
    with ``seed`` before each replay."""
    active = _running()
    if active is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return gen
    return active.generator(device, seed)


def constant(make):
    """``make()``: a tensor the body reads but cannot make inside a graph
    (a host-to-device copy).  Inside a body it is made once, before the
    capture, and every replay reads the same tensor; ``make`` must give
    the same value for the same key."""
    active = _running()
    return make() if active is None else active.constant(make)


def deferring():
    """Whether a body is running: a guard inside it must not read the host
    and hands its verdict to :func:`guard`."""
    return _running() is not None


def guard(bad):
    """Hand a solve's guard verdict (a boolean device tensor) to the running
    body: :func:`stage` reads it after the replay."""
    _running().guards.append(bad)


class Entry:
    """The captured form of one key (see the module docstring)."""

    def __init__(self, device, inputs, gen):
        self.device = device
        self.inputs = inputs
        self.gen = gen
        self.gens, self.seeds, self.constants, self.guards = [], [], [], []
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs, self.launches, self.steps = [], [], []
        self.outputs = None
        self.capture_s = 0.0

    def _play(self, i):
        self.graphs[i].replay()
        for kernel, n in zip(_COUNTED, self.launches[i]):
            kernel.LAUNCHES += n

    def _seed(self, seed):
        self.gen.manual_seed(seed)
        for gen, s in zip(self.gens, self.seeds):
            gen.manual_seed(s)

    def replay(self, inputs, seed):
        """Every graph and step in order on the current stream, from
        ``inputs`` and ``seed``; returns the static outputs (not cloned)."""
        for static, value in zip(self.inputs, inputs):
            static.copy_(value)
        self._seed(seed)
        for i in range(len(self.graphs)):
            if i:
                self.steps[i - 1].rerun()
            self._play(i)
        return self.outputs

    def tripped(self):
        """Whether a guard of the last replay tripped (one host read)."""
        return bool(self.guards) and bool(torch.stack(self.guards).any())


class _Capture(Segments):
    """Segments captured as CUDA graphs into ``entry``, each replayed as
    soon as its capture ends; the nested generators and the constants are
    the entry's, made before the capture."""

    def __init__(self, entry):
        super().__init__()
        self.entry = entry
        self.steps = entry.steps
        self.guards = entry.guards
        self.graph = None
        self.mark = ()

    def begin(self):
        super().begin()
        graph = torch.cuda.CUDAGraph()
        for gen in (self.entry.gen, *self.entry.gens):
            graph.register_generator_state(gen)
        self.mark = _launches()
        graph.capture_begin(pool=self.entry.pool)
        self.graph = graph

    def end(self):
        graph, self.graph = self.graph, None
        graph.capture_end()
        super().end()
        # the wrappers counted their calls, but a capture launches nothing
        captured = tuple(now - then for now, then in zip(_launches(), self.mark))
        for kernel, then in zip(_COUNTED, self.mark):
            kernel.LAUNCHES = then
        self.entry.graphs.append(graph)
        self.entry.launches.append(captured)
        self.entry._play(len(self.entry.graphs) - 1)

    def generator(self, device, seed):
        i = len(self.seeds)
        if i >= len(self.entry.seeds) or self.entry.seeds[i] != seed:
            raise RuntimeError("the captured body draws other than its warm-up did")
        self.seeds.append(seed)
        return self.entry.gens[i]

    def constant(self, make):
        i = len(self.constants)
        if i >= len(self.entry.constants):
            raise RuntimeError("the captured body reads a constant its warm-up did not")
        self.constants.append(self.entry.constants[i])
        return self.entry.constants[i]

    def abort(self):
        """End a capture that a failure left open, discarding it."""
        if self.graph is not None:
            graph, self.graph = self.graph, None
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture was already invalidated; the failure is raised


def _launches():
    """Each kernel's launch count, in the order of :data:`_COUNTED`."""
    return tuple(kernel.LAUNCHES for kernel in _COUNTED)


def _tensors(out):
    return [x for x in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(x, torch.Tensor)]


def clone(out):
    """A copy of a nested result (tensors cloned; tuples, lists and dicts
    rebuilt), for the caller to keep across replays."""
    if isinstance(out, dict):
        return {k: clone(v) for k, v in out.items()}
    if isinstance(out, list):
        return [clone(x) for x in out]
    if isinstance(out, tuple):
        return tuple(clone(x) for x in out)
    return out.clone() if isinstance(out, torch.Tensor) else out


def _capture(fn, inputs, seed):
    device = inputs[0].device
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device=device)
    stream = _STREAMS[device]
    caller = torch.cuda.current_stream(device)
    t0 = time.perf_counter()
    stream.wait_stream(caller)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        gen = torch.Generator(device=device)
        entry = Entry(device, tuple(x.clone() for x in inputs), gen)
        gen.manual_seed(seed)
        warm = Segments()
        warm(fn, gen, *entry.inputs)  # the warm-up
        torch.cuda.synchronize(device)
        entry.seeds, entry.constants = warm.seeds, warm.constants
        entry.gens = [torch.Generator(device=device) for _ in warm.seeds]
        entry._seed(seed)
        capture = _Capture(entry)
        try:
            entry.outputs = capture(fn, gen, *entry.inputs)
        finally:
            capture.abort()
    caller.wait_stream(stream)
    torch.cuda.synchronize(device)
    entry.capture_s = time.perf_counter() - t0
    return entry


def run(key, fn, inputs, seed):
    """``fn(gen, *inputs)`` with ``gen`` seeded by ``seed``, replayed from
    the graphs cached under ``key``, or captured first; returns its
    outputs, cloned.  ``key`` must fix everything that shapes the work:
    the inputs' shapes, dtypes and device, and every argument ``fn`` closes
    over.  Inside a running body ``fn`` runs inline, its generator from
    :func:`generator`, and no entry opens."""
    active = _running()
    if active is not None:
        return fn(active.generator(inputs[0].device, seed), *inputs)
    entry = _CACHE.get(key)
    if entry is None:
        entry = _CACHE[key] = _capture(fn, inputs, seed)
        out = entry.outputs
    else:
        out = entry.replay(inputs, seed)
    return clone(out)


def captured(X, mc_samples, solver, gram_side):
    """The route rule of the entry points: whether a call is captured.

    A call is captured when all of these hold:

    * its tensors are on CUDA (``X``; the parameters were checked to lie
      with it);
    * its loss factors are exact (``mc_samples == 0``): Monte-Carlo draws
      come from CPU generators (:func:`vivit_tpu_torch.losses.sample_generator`);
    * every Gram solve stays on ``eigh_dc``'s chain path or does not run
      it: ``solver`` other than ``"dc"`` (the vendor eigh, or LOBPCG as one
      eager step), or ``gram_side()``, the side of the Gram it solves
      (``(C−1)·S`` deflated, ``C·S`` not), below the strip threshold 1536.

    Anything else runs eagerly, exactly as an uncaptured call does.  This
    is a route, not a fallback: a captured call whose capture fails
    raises.  :func:`stage` asks on each call of a key without an entry."""
    if not X.is_cuda or mc_samples:
        return False
    if solver != "dc":
        return True
    from vivit_tpu_torch.eigdc import _STRIP_MIN

    return gram_side() < _STRIP_MIN


def gram_side(model_fn, params, X, subsampling, deflate):
    """The side of the Gram a call solves, ``(C−1)·S`` with ``deflate``,
    else ``C·S``: ``C`` from one forward of one sample, ``S`` the
    ``subsampling`` count or the batch."""
    with torch.no_grad():
        c = model_fn(params, X[:1]).shape[-1]
    return (c - bool(deflate)) * (X.shape[0] if subsampling is None else len(subsampling))


class _Ref:
    """An object in a key by identity.  The key holds it, so that its
    ``id`` cannot pass to another object while the key lives."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Ref) and other.obj is self.obj


def _part(value):
    """A setting as a hashable key part: sequences and dicts element by
    element; a callable by its ``graph_key`` attribute where it has one
    (:func:`~vivit_tpu_torch.optim.constant_damping` by its value), else by
    identity."""
    if isinstance(value, dict):
        return tuple((k, _part(v)) for k, v in value.items())
    if isinstance(value, (list, tuple, range)):
        return tuple(_part(v) for v in value)
    if callable(value) and not isinstance(value, type):
        return getattr(value, "graph_key", None) or _Ref(value)
    return value


def _spec(t):
    return tuple(t.shape), t.stride(), t.dtype, t.device


def entry_key(name, model, params, X, y, loss, **settings):
    """The cache key of one call of an entry point ``name``: ``(family,
    addresses)``.

    ``family`` holds the model by identity (:class:`_Ref`), each module's
    type and mode, every parameter (a module's buffers too, a model
    function's ``params``) by name with its shape, stride, dtype and device,
    ``X``'s and ``y``'s, the loss's type and reduction (a custom loss's
    function by identity), the cuDNN and TF32 flags and ``settings`` (see
    :func:`_part`).  ``addresses`` are a module's tensors' ``data_ptr``s,
    ``()`` for a model function.

    A model function's ``params`` are static inputs, copied in before each
    replay as ``X`` and ``y`` are (:func:`stage`): a new dict of the same
    specs, as a functional update makes, replays.  A module's graphs read
    its tensors in place: an in-place update (an optimizer step,
    ``load_state_dict``) keeps the key, a replaced tensor changes the
    addresses and captures anew, dropping the family's stale entry."""
    from vivit_tpu_torch.engines import is_module

    if is_module(model):
        tensors = [*model.named_parameters(), *model.named_buffers()]
        structure = tuple((type(m), m.training) for m in model.modules())
        addresses = tuple(t.data_ptr() for _, t in tensors)
    else:
        tensors, structure, addresses = list(params.items()), (), ()
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    family = (name, _Ref(model), structure, tuple((n, *_spec(t)) for n, t in tensors),
              _spec(X), _spec(y), type(loss), loss.reduction,
              _part(getattr(loss, "_fn", None)), flags,
              tuple((k, _part(v)) for k, v in sorted(settings.items())))
    return family, addresses


def stage(key, body, X, y, params, route):
    """``body(X, y, params)``, one program of an entry point: ``(outputs,
    replayed)``.  ``key`` comes from :func:`entry_key`; ``params`` is a
    model function's dict or ``None`` (a module's tensors, read in place).

    A key without an entry asks ``route()`` (:func:`captured`) on each call.
    Uncaptured, the body runs eagerly on the caller's tensors.  Captured,
    the first call captures it (:func:`run`'s warm-up and capture; ``X``,
    ``y`` and ``params``' tensors are its static inputs, copied in before
    every replay), dropping the entries of the key's family at other
    addresses, and later calls replay it; ``outputs`` are then the entry's
    static outputs, which the next replay overwrites.  After the replay the
    guards its solves handed to :func:`guard` are read at once; if one
    tripped, the body runs again eagerly, where the tripped solve warns and
    takes the vendor's result (its downstream work consumed the solve
    inside the graphs).  Inside a running body, inline."""
    if _ACTIVE is not None:
        return body(X, y, params), False
    names = () if params is None else tuple(params)

    def flat(_gen, X, y, *values):
        return body(X, y, None if params is None else dict(zip(names, values)))

    inputs = (X, y, *(params[n].detach() for n in names))
    entry = _CACHE.get(key)
    if entry is None:
        if not route():
            return body(X, y, params), False
        for stale in [k for k in _CACHE if k[0] == key[0]]:
            del _CACHE[stale]
        entry = _CACHE[key] = _capture(flat, inputs, 0)
        out = entry.outputs
    else:
        out = entry.replay(inputs, 0)
    if entry.tripped():
        return body(X, y, params), False
    return out, True


def entry(key, body, X, y, params, route):
    """:func:`stage`'s outputs, cloned where they came from the graphs."""
    out, replayed = stage(key, body, X, y, params, route)
    return clone(out) if replayed else out


def entries():
    """The cache: ``{key: Entry}`` (read only)."""
    return dict(_CACHE)


def clear():
    """Drop every entry and its memory pool."""
    devices = {entry.device for entry in _CACHE.values()}
    for device in devices:
        torch.cuda.synchronize(device)
    _CACHE.clear()
    if devices:
        torch.cuda.empty_cache()
