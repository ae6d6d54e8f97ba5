"""The profiler arithmetic: what the per-layer metrics and the ``device``
and ``breakdown`` fields of a traced run read from ``torch.profiler``.

A traced block is a list of :class:`Event` (host or device, name, start and
end in microseconds on the host's clock) and what the harness knew around
it: the queries run, the host-clock length of the block, the program's
kernel counters and the batches the kernels were handed.
"""

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# the runtime calls that launch device work outside a CUDA graph
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
# the runtime calls at which the host waits for the device
SYNC_APIS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
             "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize")
# the program's kernels by their device names
KERNELS = {"jacobi_window": "jacobi_kernel", "jacobi_leaf": "leaf_eigh_kernel"}


@dataclass
class Event:
    name: str
    on_device: bool
    start_us: float
    end_us: float
    thread: int = 0


@dataclass
class Trace:
    """One traced block of ``queries`` queries on one card."""

    events: List[Event]
    queries: int
    window_s: float
    query_ms: float = 0.0  # the untraced window's, for the shares of peak
    least_s: float = 0.0  # a query's least time on this card (counts.least_seconds)
    counters: Dict[str, int] = field(default_factory=dict)  # launches in the block
    batches: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)  # per query
    harness_syncs: int = 0  # the harness's own synchronize calls in the block
    bounds_us: Tuple[float, float] = (0.0, 0.0)  # the block on the events' clock
    window_queries: int = 0  # the untraced window's queries
    latencies: List[float] = field(default_factory=list)  # and their seconds
    window_trips: int = 0  # and the guard trips in them


def from_profiler(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), e.device_type() == DeviceType.CUDA, start,
                         start + e.duration_ns() / 1e3, e.start_thread_id()))
    return out


def device_events(events):
    """The device's work: kernels, copies, fills; not the ranges that
    ``torch.distributed`` annotates on the device (``nccl:all_gather``),
    which span a collective's waiting too."""
    return [e for e in events if e.on_device and not e.name.startswith("nccl:")]


def union_us(events) -> float:
    """Length of the union of the device events' intervals."""
    spans = sorted((e.start_us, e.end_us) for e in device_events(events))
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_s(trace: Trace) -> float:
    return union_us(trace.events) / 1e6


def idle_share(trace: Trace) -> float:
    """``1 - busy / window``, as a fraction."""
    return 1.0 - busy_s(trace) / trace.window_s


def host_count(trace: Trace, names) -> int:
    return sum(1 for e in trace.events if not e.on_device and e.name in names)


def launches_outside_graphs(trace: Trace) -> float:
    """Launches of device work outside ``cudaGraphLaunch`` per query."""
    return host_count(trace, LAUNCH_APIS) / trace.queries


def host_syncs(trace: Trace) -> float:
    """Host waits for the device per query, the harness's own
    end-of-query synchronize left out."""
    return (host_count(trace, SYNC_APIS) - trace.harness_syncs) / trace.queries


def device_ms(trace: Trace, match) -> float:
    """Device time of the events whose name satisfies ``match``, summed."""
    return sum(e.end_us - e.start_us for e in device_events(trace.events)
               if match(e.name)) / 1e3


def kernel_launches(trace: Trace, kernel: str) -> int:
    name = KERNELS[kernel]
    return sum(1 for e in device_events(trace.events) if name in e.name)


def roofline_pct(trace: Trace, kernel: str, least_seconds) -> Optional[float]:
    """The kernel's roofline share in percent: the least time of the
    batches it was handed (``least_seconds``, :func:`counts.roofline_seconds`)
    over its measured device time, or ``None`` where it did not launch.
    Raises where the trace and the program's counter disagree."""
    launched = kernel_launches(trace, kernel)
    counted = trace.counters.get(kernel, 0)
    if launched != counted:
        raise RuntimeError(f"{kernel}: the trace holds {launched} launches, the "
                           f"program's counter {counted}")
    if not launched:
        return None
    name = KERNELS[kernel]
    measured = device_ms(trace, lambda n: name in n) / 1e3
    least = least_seconds(trace.batches[kernel]) * trace.queries
    return 100.0 * least / measured


def top_device_ops(trace: Trace, top=10):
    """``[[name, seconds], ...]``: the device operations that took most time."""
    totals: Dict[str, float] = {}
    for e in device_events(trace.events):
        totals[e.name] = totals.get(e.name, 0.0) + (e.end_us - e.start_us) / 1e6
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], secs] for name, secs in ranked]


def idle_gaps(trace: Trace, t0_us: float, t1_us: float, top=10):
    """``[[host activity, seconds], ...]``: the device's idle time inside
    ``[t0_us, t1_us]``, each gap named by the innermost host event running
    at its middle, summed by name, the longest first."""
    spans = sorted((e.start_us, e.end_us) for e in device_events(trace.events))
    gaps, edge = [], t0_us
    for s, e in spans:
        if s > edge:
            gaps.append((edge, min(s, t1_us)))
        edge = max(edge, e)
    if edge < t1_us:
        gaps.append((edge, t1_us))
    host = sorted((e for e in trace.events if not e.on_device), key=lambda e: e.start_us)
    totals: Dict[str, float] = {}
    # a sweep over the gaps' middles: the heap holds the host events begun,
    # the shortest on top; one that has ended is dropped when it surfaces
    active, i = [], 0
    for s, e in sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] + g[1]):
        mid = (s + e) / 2
        while i < len(host) and host[i].start_us <= mid:
            h = host[i]
            heapq.heappush(active, (h.end_us - h.start_us, h.end_us, i))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = host[active[0][2]].name if active else "host: outside any traced event"
        totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], secs] for name, secs in ranked]
