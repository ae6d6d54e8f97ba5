"""Entry ``eigvalsh_structured``: the GGN spectrum of one batch, the
program's ``vivit_tpu_torch.eigvalsh_structured`` on the cell's network
with the configuration's settings, judged by :func:`judge.spectrum`."""

import judge
import program
from program import counters, instrument, release  # noqa: F401
from reference import ggn

LOW = {"bf16": "bfloat16", None: "float32", "highest": "float32"}


def prepare(ctx):
    """``query(X, y)``: the ascending spectrum of the batch."""
    import vivit_tpu_torch as vtt

    loss = program.loss(ctx.config)
    kw = program.keywords(vtt.eigvalsh_structured, ctx)

    def query(X, y):
        return vtt.eigvalsh_structured(ctx.model, loss, X, y, **kw)[0]

    return query


def low_dtype(config):
    import torch

    return getattr(torch, LOW[config["settings"].get("gram_precision")])


def reference(ctx, q, control=False):
    """The spectrum of batch ``q`` by the plain reference: float64, or for
    the control float32 with TF32."""
    import torch

    dtype = torch.float32 if control else torch.float64
    return ggn.spectrum(ctx.model, *ctx.batch(q), low=low_dtype(ctx.config), dtype=dtype,
                        tf32=control)


def compare(ctx, q, out, ref):
    return judge.spectrum(out, ref, ctx.config["batch"])
