"""Run a function on every rank of a fresh process group on this host.

    from vivit_tpu_torch.parallel.launch import spawn
    results = spawn(fn, 4)  # fn(rank, world_size, *args) in 4 gloo ranks

``fn`` must be importable by name (a module-level function), as
``multiprocessing``'s spawn start method needs.  Each rank joins the group
at ``tcp://127.0.0.1:<port>`` (a free port picked by binding port 0),
runs ``fn`` with one torch thread and hands its return value
back through a queue; :func:`spawn` returns them in rank order, or raises
``RuntimeError`` with the traceback of the first rank that failed, after
stopping the others.
"""

import datetime
import queue as queue_mod
import socket
import time
import traceback


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, port, backend, timeout, args, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if "nccl" in backend:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, args=(), *, backend: str = "gloo",
          timeout: float = 600.0) -> list:
    """``[fn(rank, world_size, *args) for each rank]``, run in ``world_size``
    spawned processes that form one process group (``backend``: ``"gloo"``
    for CPU tensors, ``"nccl"`` for CUDA tensors, rank ``r`` on card
    ``r``).  ``timeout`` (seconds) bounds the whole run and each
    collective.  Every process started is stopped before this returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world_size, port, backend, timeout, args, results))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    out, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size and failure is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                # a rank that returned exits 0 after its result is queued
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    failure = (f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                               "before returning")
                elif time.monotonic() > deadline:
                    failure = f"no result from every rank after {timeout} s"
                continue
            if ok:
                out[rank] = payload
            else:
                failure = f"rank {rank} of {world_size} failed:\n{payload}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()  # the others may wait in a collective
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[rank] for rank in range(world_size)]
