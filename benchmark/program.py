"""The benchmark's link to the program under test, ``vivit_tpu_torch``:
what every entry file shares.  The program is imported only when a run
asks for it, never by the reference."""

import inspect

# the program's kernels: (module, wrapper) of each, by the benchmark's name
KERNEL_WRAPPERS = {
    "jacobi_window": ("vivit_tpu_torch.kernels.jacobi_cuda", "batched_eigh_jacobi_cuda"),
    "jacobi_leaf": ("vivit_tpu_torch.kernels.jacobi_leaf_cuda", "batched_eigh_leaf_cuda"),
}


def _module(name):
    import importlib

    return importlib.import_module(name)


def instrument(recorder):
    """Record the batches handed to each kernel's wrapper."""
    for kernel, (module, wrapper) in KERNEL_WRAPPERS.items():
        recorder.install(kernel, _module(module), wrapper)


def counters():
    """Each kernel's launch counter (a replay adds what its graphs hold)."""
    return {kernel: _module(module).LAUNCHES
            for kernel, (module, _) in KERNEL_WRAPPERS.items()}


def release(ctx):
    """Drop the program's captured graphs and their memory pools."""
    from vivit_tpu_torch.utils import graphs

    graphs.clear()


def loss(config):
    import vivit_tpu_torch as vtt

    spec = config["loss"]
    if spec["name"] != "cross_entropy":
        raise ValueError(f"no loss {spec['name']!r} in the program's entries")
    return vtt.CrossEntropyLoss(spec["reduction"])


def keywords(fn, ctx):
    """The configuration's settings that ``fn`` takes, and the cell's own
    keywords, on the rank's card."""
    taken = inspect.signature(fn).parameters
    kw = {k: v for k, v in ctx.config["settings"].items() if k in taken}
    kw.update(ctx.workload.get("kwargs", {}))
    kw["device"] = ctx.device
    return kw
