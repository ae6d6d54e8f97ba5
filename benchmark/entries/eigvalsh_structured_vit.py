"""Entry ``eigvalsh_structured_vit``: the GGN spectrum of one batch through
the program's ``vivit_tpu_torch.eigvalsh_structured``, driven as the entry
``eigvalsh_structured`` drives it, on a network whose whole ``V`` the plain
reference cannot hold: judged by :func:`judge.spectrum` against
:mod:`reference.ggn_blocks`, the Gram summed over groups of parameters.
Its counters add the program's parameters sent to the generic engine
(``generic_params``) and token blocks formed (``token_blocks``) to the
kernels' launches, where the program has them."""

import os

import counts_vit
import judge
import program
from program import instrument, release  # noqa: F401
from reference import ggn_blocks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's counters besides the kernels': (key, module, attribute)
COUNTERS = (("generic_params", "vivit_tpu_torch.tapped", "GENERIC_PARAMS"),
            ("token_blocks", "vivit_tpu_torch.structured", "TOKEN_BLOCKS"))


def _spectrum_entry():
    import harness

    return harness.load_module(ROOT, "entries", "eigvalsh_structured")


def prepare(ctx):
    """``query(X, y)``: the ascending spectrum of the batch; the
    configuration handed to :mod:`counts_vit` for the readers."""
    counts_vit.CONFIG = ctx.config
    return _spectrum_entry().prepare(ctx)


def counters():
    import importlib

    out = program.counters()
    for key, module, attr in COUNTERS:
        value = getattr(importlib.import_module(module), attr, None)
        if value is not None:
            out[key] = value
    return out


def reference(ctx, q, control=False):
    """The spectrum of batch ``q`` by :mod:`reference.ggn_blocks`: float64,
    or for the control float32 with TF32."""
    import torch

    dtype = torch.float32 if control else torch.float64
    return ggn_blocks.spectrum(ctx.model, *ctx.batch(q),
                               low=_spectrum_entry().low_dtype(ctx.config), dtype=dtype,
                               tf32=control)


def compare(ctx, q, out, ref):
    return judge.spectrum(out, ref, ctx.config["batch"])
