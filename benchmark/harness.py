"""The benchmark's harness: one run of one cell.

A cell (``workloads/<name>.json``) names a configuration
(``configs/<name>.json``), whose ``network`` names a network file
(``networks/<name>.py``), and an ``entry`` (``entries/<name>.py``) that
drives the program under test and judges its answers against the plain
reference (``reference/``).  The metrics a cell reports are those of
``BENCHMARK.json`` that name it, or that name no cell; each per-layer
metric is read by ``metrics/<name>.py``.  A new cell, configuration or
metric is a new file and a new entry of ``BENCHMARK.json``.

A run:

1. set-up: the network's weights made on each card from ``--seed``; the
   query shape warmed up by queries 0 and 1 (the program builds its kernels
   and captures its graphs there);
2. the window: a closed loop, one caller that issues query ``q`` on batch
   ``q`` and waits for it (``synchronize``), for ``--seconds``; with
   ``--trace 1`` then ``trace_queries`` more under ``torch.profiler``.
   Batch ``q`` is drawn on the card from ``(seed, q)`` before the query
   is issued: every query sees new data, as a training step does;
3. the check, after the program's state is released: the answers to a
   sample of the window's queries drawn from the seed against the
   reference's, on the same batches;
4. the result: one JSON line, the last of standard output.

With ``chips`` above 1 each card has one process, rank ``r`` on card
``r``, joined by NCCL (the program's collectives) and by a gloo group (the
harness's own: when to stop, and what each rank measured).  Rank 0 runs in
the calling process and prints the result.
"""

import datetime
import importlib.util
import json
import math
import os
import random
import socket
import sys
import time
import warnings

import counts
import timeline

ROOT = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "vivit_tpu")


def load_module(root, folder, name):
    """``<root>/<folder>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(root, folder, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_{folder}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(root, folder, name):
    path = os.path.join(root, folder, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """A cell's files: ``workload``, ``config`` (dicts), ``network`` and
    ``entry`` (modules), and its metrics from ``benchmark`` (the parsed
    ``BENCHMARK.json``)."""

    def __init__(self, name, benchmark, root=ROOT):
        self.name = name
        self.root = root
        self.workload = load_json(root, "workloads", name)
        self.config = load_json(root, "configs", self.workload["config"])
        self.network = load_module(root, "networks", self.config["network"])
        self.entry = load_module(root, "entries", self.workload["entry"])
        entries = {w["name"]: w for w in benchmark["workloads"]}
        if name not in entries:
            raise KeyError(f"BENCHMARK.json has no cell {name!r}")
        self.chips = entries[name]["chips"]

        def mine(metric):
            return "workloads" not in metric or name in metric["workloads"]

        self.end_to_end = [m for m in benchmark["end_to_end"] if mine(m)]
        self.per_layer = [m for m in benchmark["per_layer"] if mine(m)]

    def reader(self, metric):
        """The reader of ``metric``; a dotted name, ``<base>.<cells>``, is
        ``<base>`` reported under a name of its own (its own bound, or its
        own end-to-end metric to move) and read by ``metrics/<base>.py``."""
        return load_module(self.root, "metrics", metric.split(".")[0])

    def checked(self, seed):
        """The queries whose answers are checked: ``check_answers`` of the
        window's first ``check_among`` (from query 2 on), drawn from the
        seed."""
        rng = random.Random(seed)
        return sorted(rng.sample(range(2, 2 + self.workload["check_among"]),
                                 self.workload["check_answers"]))


class Context:
    """What an entry file gets: the cell, the card, the rank, the network,
    the batches (``batch(q)``) and the process groups (``None`` on one
    card)."""

    def __init__(self, cell, device, rank, world, model, batches, group=None):
        self.cell, self.device, self.rank, self.world = cell, device, rank, world
        self.config, self.workload = cell.config, cell.workload
        self.model, self.batch, self.group = model, batches, group


def _mix(seed, q):
    """A 64-bit generator seed of ``(seed, q)`` (splitmix64's finalizer), so
    that near seeds and queries draw unrelated batches."""
    mask = (1 << 64) - 1
    x = (seed * 0x9E3779B97F4A7C15 + q + 1) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    return x ^ (x >> 31)


class Batches:
    """Batch ``q`` of a run, ``(X [N, H, W, C] ~ N(0, 1), y [N]`` uniform
    over the classes), drawn on the card from ``(seed, q)``: the same on
    every rank and in the check."""

    def __init__(self, cfg, seed, device):
        import torch

        self.cfg, self.seed, self.device = cfg, seed, device
        self.gen = torch.Generator(device=device)

    def __call__(self, q):
        import torch

        cfg = self.cfg
        self.gen.manual_seed(_mix(self.seed, q))
        X = torch.randn((cfg["batch"], *cfg["image"]), generator=self.gen, device=self.device)
        y = torch.randint(0, cfg["num_classes"], (cfg["batch"],), generator=self.gen,
                          device=self.device)
        return X, y


def make_inputs(cell, seed, device):
    """The network, its weights drawn on ``device`` from ``seed`` in one
    call, and the run's :class:`Batches`."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return cell.network.build(cell.config, device, gen), Batches(cell.config, seed, device)


class Recorder:
    """Records the batches handed to the program's kernel wrappers
    (``(b, m)`` of each call, tagged with the query running), wrapping them
    in place for the whole run."""

    def __init__(self):
        self.tag = None
        self.calls = {}

    def install(self, kernel, module, attr):
        original = getattr(module, attr)
        calls = self.calls.setdefault(kernel, [])

        def recording(A, *args, **kwargs):
            calls.append((self.tag, int(A.shape[0]), int(A.shape[-1])))
            return original(A, *args, **kwargs)

        setattr(module, attr, recording)

    def per_query(self, kernel, launches, traced_tags):
        """One query's batches: those recorded in the traced block (an eager
        path), else the last ``launches`` of the last call that recorded
        any (the capture, whose replays call no Python)."""
        calls = self.calls.get(kernel, [])
        traced = [(b, m) for tag, b, m in calls if tag in traced_tags]
        if traced:
            first = [(b, m) for tag, b, m in calls if tag == min(traced_tags)]
            return first
        if not calls or not launches:
            return []
        last = calls[-1][0]
        mine = [(b, m) for tag, b, m in calls if tag == last]
        return mine[-launches:]


def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(args, t_start, device_type="cuda", root=ROOT):
    """One run of ``args.workload``; returns the result dict (rank 0)."""
    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as fh:
        benchmark = json.load(fh)
    cell = Cell(args.workload, benchmark, root)
    world = cell.chips
    if world == 1:
        return rank_main(0, 1, None, vars(args), t_start, device_type, root)
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, daemon=True,
                         args=(r, world, port, vars(args), t_start, device_type, root))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        return rank_main(0, world, port, vars(args), t_start, device_type, root)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()


def rank_main(rank, world, port, args, t_start, device_type="cuda", root=ROOT):
    """The run on one rank; rank 0 returns the result, the others ``None``."""
    import torch

    torch.set_num_threads(1)
    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as fh:
        cell = Cell(args["workload"], json.load(fh), root)
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    groups = None
    if world > 1:
        import torch.distributed as dist

        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
        groups = dist.new_group(backend="gloo")
    try:
        return _measure(cell, args, rank, world, device, groups, t_start)
    finally:
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _go(flag, groups):
    """Rank 0's decision to run one more query, shared with every rank."""
    if groups is None:
        return flag
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(flag)])
    dist.broadcast(t, 0, group=groups)
    return bool(t.item())


def _gather(obj, groups, world):
    if groups is None:
        return [obj]
    import torch.distributed as dist

    out = [None] * world
    dist.all_gather_object(out, obj, group=groups)
    return out


def _measure(cell, args, rank, world, device, groups, t_start):
    import torch

    seed, seconds, trace = args["seed"], args["seconds"], bool(args["trace"])
    if args.get("plant"):  # a test's fault, planted in the program in every rank
        path, fn = args["plant"].rsplit(":", 1)
        spec = importlib.util.spec_from_file_location("bench_plant", path)
        planter = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(planter)
        getattr(planter, fn)()
    recorder = Recorder()
    cell.entry.instrument(recorder)
    model, batches = make_inputs(cell, seed, device)
    ctx = Context(cell, device, rank, world, model, batches, groups)
    query = cell.entry.prepare(ctx)
    checked = set(cell.checked(seed))
    kept = {}

    # set-up: queries 0 and 1 (the first call captures)
    for q in range(2):
        recorder.tag = ("setup", q)
        query(*batches(q))
    _sync(device)
    setup_s = time.time() - t_start

    lat, trips, q = [], [], 2
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while _go(q == 2 or time.perf_counter() < deadline, groups):
            batch = batches(q)
            recorder.tag = ("window", q)
            seen = len(caught)
            ts = time.perf_counter()
            out = query(*batch)
            _sync(device)
            lat.append(time.perf_counter() - ts)
            if q in checked:
                kept[q] = out
            if any("guard tripped" in str(w.message) for w in caught[seen:]):
                trips.append(q)
            q += 1
        window_s = time.perf_counter() - t0
        query_ms = 1e3 * window_s / len(lat)
        traced = None
        if trace:
            traced = _traced_block(cell, query, recorder, batches, q, device)
            traced.query_ms, traced.latencies = query_ms, lat
            traced.window_queries, traced.window_trips = len(lat), len(trips)
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0

    # the check: the program's state released, the reference on rank 0
    del query, out
    cell.entry.release(ctx)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed, uncompared = _check(cell, ctx, kept) if rank == 0 else (None,) * 3

    per_rank = _gather({"peak": peak,
                        "busy_s": None if traced is None else timeline.busy_s(traced)},
                       groups, world)
    if rank != 0:
        return None
    return _result(cell, ctx, checks, failed, uncompared, len(lat), query_ms, setup_s,
                   per_rank, traced, trips, kept)


def _check(cell, ctx, kept):
    """``([(name, worst reading, limit)], answers failed, {name: worst
    reading})``: each kept answer against the reference's on its batch, by
    the entry's readings; those the cell gives no limit are not compared,
    only reported."""
    limits = cell.workload["limits"]
    worst, failed = {}, 0
    for q in sorted(kept):
        readings = cell.entry.compare(ctx, q, kept[q], cell.entry.reference(ctx, q))
        failed += any(not readings[name] <= limit for name, limit in limits.items())
        for name, value in readings.items():
            prev = worst.get(name)
            if prev is None or math.isnan(value) or (not math.isnan(prev) and value > prev):
                worst[name] = value  # a NaN, once read, stays
    return ([(name, worst.get(name, math.nan), limit) for name, limit in limits.items()],
            failed, {k: v for k, v in worst.items() if k not in limits})


def _traced_block(cell, query, recorder, batches, q0, device):
    from torch.profiler import ProfilerActivity, profile

    count = cell.workload["trace_queries"]
    before = cell.entry.counters()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    tags = []
    with profile(activities=activities) as prof:
        t0, w0 = time.perf_counter(), time.time_ns() / 1e3
        for q in range(q0, q0 + count):
            batch = batches(q)
            recorder.tag = ("trace", q)
            tags.append(recorder.tag)
            query(*batch)
            _sync(device)
        window_s = time.perf_counter() - t0
        w1 = time.time_ns() / 1e3
    counters = {k: v - before[k] for k, v in cell.entry.counters().items()}
    return timeline.Trace(
        events=timeline.from_profiler(prof), queries=count, window_s=window_s,
        counters=counters,
        batches={k: recorder.per_query(k, n // count, tags) for k, n in counters.items()},
        harness_syncs=count if device.type == "cuda" else 0, bounds_us=(w0, w1))


def _result(cell, ctx, checks, failed, uncompared, queries, query_ms, setup_s, per_rank,
            traced, trips, kept):
    import torch

    compared = len(kept)
    correct = compared > 0 and failed == 0 and all(value <= limit
                                                  for _, value, limit in checks)
    peak = max(r["peak"] for r in per_rank)
    e2e = {
        "query_ms": query_ms,
        "peak_mem_gb": peak / 1e9,
        "setup_s": setup_s,
    }
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                       else "cpu"),
              "count": ctx.world, "memory_peak_bytes": int(peak)}
    attempted = queries + (traced.queries if traced is not None else 0)
    result = {"correct": correct, "attempted": attempted,
              "failed": failed if compared else attempted}
    if traced is None:
        # a dotted name, ``query_ms.<cells>``, is ``query_ms`` under a bound of its own
        result["metrics"] = {m["name"]: {"value": e2e[m["name"].split(".")[0]],
                                         "unit": m["unit"]} for m in cell.end_to_end}
    else:
        cfg = cell.config
        parts = counts.query_parts(cell.network.layers(cfg), cfg["batch"], cfg["num_classes"],
                                   cell.workload.get("kwargs", {}).get("k", 0))
        traced.least_s = counts.least_seconds(parts, ctx.world)
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        busy = [r["busy_s"] for r in per_rank]
        device["busy_s"] = sum(busy) / len(busy)
        device["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": timeline.top_device_ops(traced),
                               "idle_gaps": timeline.idle_gaps(traced, *traced.bounds_us)}
    result["device"] = device
    result["info"] = {"queries_compared": compared, "window_guard_trips": len(trips),
                      "checked_queries": sorted(kept), "not_compared": uncompared}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    return result
