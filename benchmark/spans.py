"""The program's spans in a traced block: what the per-layer metrics of the
port's stages read.

The program records its stages (``vivit_tpu_torch.utils.trace``) while a
``torch.profiler`` session runs, on the host clock of the profiler's
events.  Its records are drained at the first read after the block and kept
here for the other readers, each block reading those that started in it.  A program without the recorder gives
nothing: every function here then returns ``None``.
"""

import bisect
import importlib

import timeline

_DRAINED = []  # every record drained from the program so far


def records(trace):
    """The program's span records that started inside the traced block, or
    ``None`` where the program records no spans."""
    try:
        recorder = importlib.import_module("vivit_tpu_torch.utils.trace")
    except ImportError:
        return None
    _DRAINED.extend(recorder.collect())
    t0, t1 = trace.bounds_us
    return [r for r in _DRAINED if t0 <= r.start_us <= t1]


def stage_ms(trace, name):
    """Device time of the spans named ``name``, summed, per query; ``None``
    where none was recorded."""
    recs = records(trace)
    if not recs:
        return None
    times = [r.device_ms for r in recs if r.name == name]
    return sum(times) / trace.queries if times else None


class _Intervals:
    """The host intervals of the spans named ``name``, merged."""

    def __init__(self, recs, name):
        merged = []
        for s, e in sorted((r.start_us, r.end_us) for r in recs if r.name == name):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]

    def __bool__(self):
        return bool(self.starts)

    def __contains__(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def device_gaps(trace):
    """``[(start, end)]``: the stretches of the traced block in which no
    operation ran on the card (host clock, microseconds)."""
    t0, t1 = trace.bounds_us
    gaps, edge = [], t0
    for s, e in sorted((e.start_us, e.end_us) for e in timeline.device_events(trace.events)):
        if s > edge:
            gaps.append((edge, min(s, t1)))
        edge = max(edge, e)
    if edge < t1:
        gaps.append((edge, t1))
    return [(s, e) for s, e in gaps if e > s]


def idle_ms(trace, name):
    """The card's idle time whose gap's middle falls inside the host
    interval of a span named ``name``: the idle the host left the card
    while in that stage, per query; ``None`` where no such span was
    recorded."""
    intervals = _Intervals(records(trace) or [], name)
    if not intervals:
        return None
    idle = sum(e - s for s, e in device_gaps(trace) if (s + e) / 2 in intervals)
    return idle / 1e3 / trace.queries


def syncs(trace, name):
    """The host's waits for the card (``timeline.SYNC_APIS``) that began
    inside a span named ``name``, per query; ``None`` where no such span was
    recorded."""
    intervals = _Intervals(records(trace) or [], name)
    if not intervals:
        return None
    waits = [e for e in trace.events
             if not e.on_device and e.name in timeline.SYNC_APIS and e.start_us in intervals]
    return len(waits) / trace.queries


def split(trace):
    """``{stage: (device ms, idle ms, syncs)}`` per query for every span
    name recorded in the block; ``{}`` where none was."""
    names = sorted({r.name for r in records(trace) or []})
    return {n: (stage_ms(trace, n), idle_ms(trace, n), syncs(trace, n)) for n in names}
