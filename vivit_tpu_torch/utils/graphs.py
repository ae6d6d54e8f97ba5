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
that the next replay cannot overwrite what a caller holds); a generator
registered with every graph and re-seeded before each replay, so that a
replay draws what an eager call with the same seed draws; and the Jacobi
kernel's launches captured in each graph, which every replay adds to
``jacobi_cuda.LAUNCHES``.

The first call per key runs ``fn`` eagerly once on a side stream, which
builds what is made at first use (the kernel's ``nvcc`` build and library,
its schedule tables, cuBLAS's workspaces), then captures it on that stream,
replaying each graph as soon as it is captured so that the next eager step
reads computed inputs; its result is the replays'.  It therefore launches
every kernel twice.  A capture that fails raises.

Like JAX's, the cache is unbounded; :func:`clear` is the counterpart of
``jax.clear_caches()``.  One capture at a time, from one thread.
"""

import time

import torch

from vivit_tpu_torch.kernels import jacobi_cuda

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
    runs, and ``steps`` gets each eager step in order (the CPU tests hold a
    body to it).  :class:`_Capture` makes each segment a CUDA graph."""

    def __init__(self):
        self.open = False
        self.steps = []

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

    def __call__(self, fn, *args):
        """``fn(*args)`` as one run of segments."""
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a captured body is already running")
        _ACTIVE = self
        try:
            self.begin()
            out = fn(*args)
            self.end()
        finally:
            self.open = False
            _ACTIVE = None
        return out


def eager(fn, *args):
    """``fn(*args)``, run outside any graph: inside a capture it ends the
    current segment, and every replay runs it eagerly at this point."""
    if _ACTIVE is None:
        return fn(*args)
    return _ACTIVE.step(fn, args)


class Entry:
    """The captured form of one key (see the module docstring)."""

    def __init__(self, device, inputs, gen):
        self.device = device
        self.inputs = inputs
        self.gen = gen
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs, self.launches, self.steps = [], [], []
        self.outputs = None
        self.capture_s = 0.0

    def _play(self, i):
        self.graphs[i].replay()
        jacobi_cuda.LAUNCHES += self.launches[i]

    def replay(self, inputs, seed):
        """Every graph and step in order on the current stream, from
        ``inputs`` and ``seed``; returns the static outputs (not cloned)."""
        for static, value in zip(self.inputs, inputs):
            static.copy_(value)
        self.gen.manual_seed(seed)
        for i in range(len(self.graphs)):
            if i:
                self.steps[i - 1].rerun()
            self._play(i)
        return self.outputs


class _Capture(Segments):
    """Segments captured as CUDA graphs into ``entry``, each replayed as
    soon as its capture ends."""

    def __init__(self, entry):
        super().__init__()
        self.entry = entry
        self.steps = entry.steps
        self.graph = None
        self.mark = 0

    def begin(self):
        super().begin()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.entry.gen)
        self.mark = jacobi_cuda.LAUNCHES
        graph.capture_begin(pool=self.entry.pool)
        self.graph = graph

    def end(self):
        graph, self.graph = self.graph, None
        graph.capture_end()
        super().end()
        # the wrapper counted its calls, but a capture launches nothing
        captured = jacobi_cuda.LAUNCHES - self.mark
        jacobi_cuda.LAUNCHES = self.mark
        self.entry.graphs.append(graph)
        self.entry.launches.append(captured)
        self.entry._play(len(self.entry.graphs) - 1)

    def abort(self):
        """End a capture that a failure left open, discarding it."""
        if self.graph is not None:
            graph, self.graph = self.graph, None
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture was already invalidated; the failure is raised


def _tensors(out):
    return [x for x in (out if isinstance(out, (tuple, list)) else (out,))
            if isinstance(x, torch.Tensor)]


def _clone(out):
    if isinstance(out, (tuple, list)):
        return tuple(_clone(x) for x in out)
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
        fn(gen, *entry.inputs)  # the warm-up
        torch.cuda.synchronize(device)
        gen.manual_seed(seed)
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
    over."""
    entry = _CACHE.get(key)
    if entry is None:
        entry = _CACHE[key] = _capture(fn, inputs, seed)
        out = entry.outputs
    else:
        out = entry.replay(inputs, seed)
    return _clone(out)


def entries():
    """The cache: ``{key: Entry}`` (read only)."""
    return dict(_CACHE)


def clear():
    """Drop every entry and release its memory pool."""
    devices = {entry.device for entry in _CACHE.values()}
    for device in devices:
        torch.cuda.synchronize(device)
    _CACHE.clear()
    if devices:
        torch.cuda.empty_cache()
