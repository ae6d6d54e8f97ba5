"""Entry ``eigvalsh_structured_lm``: the GGN-MC spectrum of a language
model on one batch of sequences, through the program's
``vivit_tpu_torch.eigvalsh_structured`` (``engine="tapped"``, Monte-Carlo
factors: the cell's ``kwargs`` give ``mc_samples`` and ``key``), judged by
:func:`judge.spectrum` against :mod:`reference.ggn_lm` with no structural
zeros (Monte-Carlo factors have none).

The network's discrete decisions, the router's choices and the sampled
labels, are handed to the reference (``PERF.md`` §7).  The reference's
decisions come from one float32 forward of the network without gradients
under the program's settings (TF32 off); the program's own are kept with
its answer: the router's choices from the network's record of the
program's forward, the labels from the program's loss.  Two readings count
the tokens whose decision differs between the two, plus those the float64
forward finds invalid: ``routing_off`` and ``labels_off``.

The routed rows change in number with every batch, and with them the
shapes of the expert layers' tensors: the configuration's deployment sets
the caching allocator for that (its ``settings["cuda_allocator"]``, in
``PYTORCH_CUDA_ALLOC_CONF``'s syntax: segments expandable, block sizes
rounded to quarters between powers of two), and on a CUDA card the entry
applies it before the program's first query, so that the memory the
allocator reserves follows what the queries hold and not how its cache
happened to split (``PERF.md`` §6).

Its counters add the program's parameters sent to the generic engine
(``generic_params``), token blocks formed (``token_blocks``) and rows
placed by sample (``routed_rows``) to the kernels' launches, where the
program has them."""

import importlib

import counts_lm
import judge
import program
from program import instrument, release  # noqa: F401
from reference import ggn_lm
from reference.ggn import precision

COUNTERS = (("generic_params", "vivit_tpu_torch.tapped", "GENERIC_PARAMS"),
            ("token_blocks", "vivit_tpu_torch.structured", "TOKEN_BLOCKS"),
            ("routed_rows", "vivit_tpu_torch.tapped", "ROUTED_ROWS"))
LOW = {"bf16": "bfloat16", None: "float32", "highest": "float32"}


def prepare(ctx):
    """``query(X, y)``: ``{"spectrum", "routing", "labels"}`` of the batch,
    the program's answer and its decisions; the configuration handed to
    :mod:`counts_lm` for the readers."""
    import torch

    import vivit_tpu_torch as vtt

    allocator = ctx.config["settings"].get("cuda_allocator")
    if allocator and ctx.device.type == "cuda":
        # the process's CUDA context exists by now (the weights are drawn),
        # so PYTORCH_CUDA_ALLOC_CONF would come too late
        torch.cuda.memory._set_allocator_settings(allocator)
    loss = program.loss(ctx.config)
    kw = program.keywords(vtt.eigvalsh_structured, ctx)
    counts_lm.CONFIG = {**ctx.config, "mc_samples": kw["mc_samples"]}
    drawn = []
    draws = loss.mc_draws

    def recording(*args, **kwargs):
        out = draws(*args, **kwargs)
        drawn[:] = [out]
        return out

    loss.mc_draws = recording

    def query(X, y):
        spectrum = vtt.eigvalsh_structured(ctx.model, loss, X, y, **kw)[0]
        return {"spectrum": spectrum, "routing": list(ctx.model.routing["recorded"]),
                "labels": drawn[0]}

    return query


def counters():
    out = program.counters()
    for key, module, attr in COUNTERS:
        value = getattr(importlib.import_module(module), attr, None)
        if value is not None:
            out[key] = value
    return out


def _decisions(ctx, X):
    """The router's choices and the labels of one float32 forward of the
    network without gradients, TF32 off."""
    import torch

    kw = ctx.workload["kwargs"]
    net = ctx.model
    with precision(False), torch.no_grad():
        net.routing["replay"] = None
        f = net(X)
        routing = list(net.routing["recorded"])
        u = ggn_lm.uniforms(kw["key"], X.shape[0], kw["mc_samples"], X.shape[1])
        label = ggn_lm.labels(f, u)
    return routing, label, u


def reference(ctx, q, control=False):
    """The spectrum of batch ``q`` by :mod:`reference.ggn_lm` under the
    float32 forward's decisions: float64, or for the control float32 with
    TF32; with the decisions and the float64 forward's count of invalid
    ones."""
    import torch

    X, _ = ctx.batch(q)
    routing, label, u = _decisions(ctx, X)
    low = getattr(torch, LOW[ctx.config["settings"].get("gram_precision")])
    dtype = torch.float32 if control else torch.float64
    spectrum, bad_labels, bad_routing = ggn_lm.spectrum(
        ctx.model, X, label, routing, u, low=low, dtype=dtype, tf32=control)
    ctx.model.routing["replay"] = None
    return {"spectrum": spectrum, "routing": routing, "labels": label,
            "labels_invalid": bad_labels, "routing_invalid": bad_routing}


def _apart(a, b, choices=False):
    """Decisions that differ: elements of ``a`` and ``b`` not equal, or
    with ``choices`` the rows (a token's top-k, in any order) not equal."""
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape:
        return float("inf")
    if choices:
        a, b = a.sort(dim=-1).values, b.sort(dim=-1).values
        return int((a != b).any(dim=-1).sum())
    return int((a != b).sum())


def compare(ctx, q, out, ref):
    readings = judge.spectrum(out["spectrum"], ref["spectrum"], 0)
    routing = (sum(_apart(a, b, True) for a, b in zip(out["routing"], ref["routing"]))
               if len(out["routing"]) == len(ref["routing"]) else float("inf"))
    readings["routing_off"] = float(routing + ref["routing_invalid"])
    readings["labels_off"] = float(_apart(out["labels"], ref["labels"]) + ref["labels_invalid"])
    readings["routing_invalid"] = float(ref["routing_invalid"])
    readings["labels_invalid"] = float(ref["labels_invalid"])
    return readings
