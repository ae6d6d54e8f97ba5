"""Entry ``eigvalsh_dp_structured``: the GGN spectrum of one global batch
split over the ranks, the program's
``vivit_tpu_torch.parallel.eigvalsh_dp_structured`` over the default
process group (NCCL, one rank per card), each rank calling it on its
``samples_per_rank`` of the batch.  Rank 0's answer, the spectrum of the
whole batch, is judged as the one-card spectrum's is."""

import os

import program
from program import counters, instrument, release  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spectrum_entry():
    import harness

    return harness.load_module(ROOT, "entries", "eigvalsh_structured")


def prepare(ctx):
    """``query(X, y)``: the spectrum of the global batch from this rank's
    shard of it."""
    from vivit_tpu_torch import parallel

    per_rank = ctx.workload["samples_per_rank"]
    if per_rank * ctx.world != ctx.config["batch"]:
        raise ValueError(f"{ctx.world} ranks of {per_rank} samples do not make the "
                         f"batch of {ctx.config['batch']}")
    kw = program.keywords(parallel.eigvalsh_dp_structured, ctx)
    fn = parallel.eigvalsh_dp_structured(ctx.model, program.loss(ctx.config), None, **kw)
    shard = slice(ctx.rank * per_rank, (ctx.rank + 1) * per_rank)

    def query(X, y):
        return fn(X[shard], y[shard])

    return query


def reference(ctx, q, control=False):
    return _spectrum_entry().reference(ctx, q, control)


def compare(ctx, q, out, ref):
    return _spectrum_entry().compare(ctx, q, out, ref)
