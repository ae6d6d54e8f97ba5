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
replay draws what an eager call with the same seeds draws; and the
kernels' launches captured in each graph, which every replay adds to their
counters (the ``LAUNCHES`` of each kernel module, which registers itself
with :func:`count_launches`).

Bodies nest.  Inside a running body :func:`run` captures nothing of its
own: its ``fn`` runs inline, its draws from a generator of its own
(:func:`generator`, seeded as an eager call seeds it), its eager steps
become the outer body's, and it opens no cache entry.  Whole calls of the
package's entry points are captured this way (:func:`stage`, keyed and
routed by :mod:`vivit_tpu_torch.engines`): the V-transform, the Gram,
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

Each entry keeps a memory pool at its call's peak.  An entry point's key,
``(family, addresses)``, holds a module's tensors' addresses, and a capture
at new addresses drops the family's entries at the old ones; beyond
that, like JAX's, the cache is unbounded, and :func:`clear`, the
counterpart of ``jax.clear_caches()``, releases every pool.  One capture
at a time, from one thread.
"""

import sys
import time

import torch

# the kernel modules whose ``LAUNCHES`` count their launches, in the order
# they registered (:func:`count_launches`): a capture launches nothing, a
# replay adds what its graphs captured
_COUNTED = []
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


def count_launches(name):
    """Register the kernel module ``name``, whose ``LAUNCHES`` its wrapper
    adds each launch to: a capture then leaves it as it was, and every
    replay adds the launches its graphs captured.  Each kernel module
    registers itself when it is imported; an entry captured before a module
    registered holds no launch of it."""
    _COUNTED.append(sys.modules[name])


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


def stage(key, body, X, y, params, route):
    """``body(X, y, params)``, one program of an entry point: ``(outputs,
    replayed)``.  ``key`` is ``(family, addresses)`` and ``route()`` the
    entry points' route rule, both from :func:`vivit_tpu_torch.engines.stage`;
    ``params`` is a model function's dict or ``None`` (a module's tensors,
    read in place).

    A key without an entry asks ``route()`` on each call.
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
