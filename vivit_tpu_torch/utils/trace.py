"""Spans: the host and device times of the port's stages, kept in memory.

The port's counterpart of the JAX package's ``jax.named_scope`` names.  A
span is a ``with span(name, like):`` block around one stage; the stages are
the entry (``eigvalsh_structured``), the V-transform (``vtransform`` and its
``.forward``, ``.loss_hessian_sqrt``, ``.backward``, ``.reconstruct``, and
inside the last ``vtransform.routing`` around each routed block's
gathering), the Gram (``gram``, and inside it ``gram.token_blocks``,
``gram.routed_blocks`` and ``gram.embedding`` around the token, routed and
embedding blocks' sums, one each a Gram), the eigensolve (``eigensolve``, ``eigh_dc.basis``,
``eigh_dc.polish``, ``eigh_dc.guard``, ``eigh_dc.rerun``) and the small
dense solves (``leaves``).

A span records only while recording is on: after ``enable(True)``, or,
before any ``enable`` call and after ``enable(None)``, while a
``torch.profiler`` session runs in this process, so that a profile carries
the stage times beside the kernels.  ``enable(False)`` keeps it off even
then.  Off, a span costs a flag test and records nothing.  Inside a body
that :mod:`vivit_tpu_torch.utils.graphs` runs (its warm-up and its capture,
and any body inlined in them) a span records nothing either: an event
recorded under stream capture would break it.  A replayed call runs no
Python of its body and is timed whole by its outermost span; a call rerun
eagerly after a guard trip records its stages.

Each record holds its name, the call it belongs to (one per outermost span:
every span of an entry point's call shares its id), its index and its
parent's, and its host start and end in microseconds on ``time.time_ns``'s
clock, which ``torch.profiler``'s events share.  Its device time is the
elapsed time between two timing events recorded on the current stream of
``like``'s card at its start and end: the stage's length on that stream,
idle gaps inside it included.  On the CPU it is the host interval.

Operator's use::

    from vivit_tpu_torch.utils import trace

    trace.enable(True)
    ...  # calls of the package
    torch.cuda.synchronize()
    for r in trace.collect():
        print(r.call, r.name, r.device_ms)

Beside the spans, the port keeps counters as module attributes, each
reset by assignment: ``eigdc.TRIPS`` (guard trips), ``tapped.GENERIC_PARAMS``
(parameters sent to the generic engine), ``tapped.ROUTED_ROWS`` (rows of
routed blocks placed by sample), ``structured.TOKEN_BLOCKS`` and
``ROUTED_BLOCKS`` (token and routed blocks formed), ``precision.THREE_PASS``
and ``THREE_PASS_DECLINED``.  A
replay runs no Python and adds nothing to them.

:func:`collect` reads the events' times; call it after a synchronize, so
that it waits for nothing.  The records live in a ring of the newest
:data:`LIMIT`; :data:`DROPPED` counts those it let go.
"""

import itertools
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.autograd.profiler as _profiler

from vivit_tpu_torch.utils import graphs

LIMIT = 1 << 16  # records kept, the newest
DROPPED = 0  # records the ring let go, since import
_MODE: Optional[bool] = None  # True on, False off, None: while a profiler runs
_RECORDS: deque = deque()
_OPEN = []  # the spans open now, outermost first
_INDEX = itertools.count()
_CALL = itertools.count()


@dataclass
class Record:
    """One span: ``name``, ``call``, ``index``, ``parent`` (an index or
    ``None``), host ``start_us`` and ``end_us``, and after :func:`collect`
    its ``device_ms``."""

    name: str
    call: int
    index: int
    parent: Optional[int]
    start_us: float
    end_us: Optional[float] = None
    device_ms: Optional[float] = None
    events: Any = None  # the (start, end) timing events on a card


def enable(on: Optional[bool] = True):
    """Recording on (``True``), off (``False``), or on while a
    ``torch.profiler`` session runs (``None``, the state at import)."""
    global _MODE
    _MODE = on


class _Off:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    def __init__(self, name, like):
        self.name = name
        self.device = getattr(like, "device", like)

    def __enter__(self):
        global DROPPED
        parent = _OPEN[-1] if _OPEN else None
        rec = Record(self.name, next(_CALL) if parent is None else parent.call, next(_INDEX),
                     None if parent is None else parent.index, time.time_ns() / 1e3)
        if self.device is not None and torch.device(self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(stream)
            self.stream = stream
        while len(_RECORDS) >= LIMIT:
            _RECORDS.popleft()
            DROPPED += 1
        _RECORDS.append(rec)
        _OPEN.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record(self.stream)
        rec.end_us = time.time_ns() / 1e3
        _OPEN.pop()
        return False


def span(name: str, like=None):
    """A block timed as the stage ``name``; ``like`` is a tensor or device
    on whose card the device time is taken (``None`` or a CPU one: the host
    interval)."""
    if not (_MODE or (_MODE is None and _profiler._is_profiler_enabled)) \
            or graphs._ACTIVE is not None:
        return _OFF
    return _Span(name, like)


def collect():
    """The finished records, oldest first, with their ``device_ms``; they
    leave the ring (open spans stay)."""
    done, kept = [], deque()
    for rec in _RECORDS:
        (done if rec.end_us is not None else kept).append(rec)
    _RECORDS.clear()
    _RECORDS.extend(kept)
    for rec in done:
        if rec.events is not None:
            rec.device_ms = rec.events[0].elapsed_time(rec.events[1])
            rec.events = None
        else:
            rec.device_ms = (rec.end_us - rec.start_us) / 1e3
    return done
