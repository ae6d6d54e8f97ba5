"""Shared parts of the data-parallel parity tests
(``tests/test_torch_port_parallel*.py``).

Each of those files runs the port's side once, in a gloo group of ``K``
CPU ranks (:func:`spawn_cases`): every rank runs every case of the file on
its shard of the global batch, and each rank's results come back as numpy.
The spawned ranks import this module and the test file, so neither imports
JAX at the top: the JAX side (:func:`jax_mesh`, the problems of
``tests/parallel/test_data_parallel.py``) is imported inside functions that
only the pytest process calls.  The JAX builders run on ``K`` of the
8 virtual CPU devices (``tests/conftest.py``), so both sides lay the global
Gram out the same way, ``(rank, cf, local_sample)``.
"""

from contextlib import contextmanager

import numpy as np
import torch
from torch import nn

import vivit_tpu_torch as vtt

K = 4
N, D_IN, H, C = 16, 5, 6, 3


class Raised:
    """A case that raised: the exception's type name and message."""

    def __init__(self, exc: BaseException):
        self.type, self.message = type(exc).__name__, str(exc)

    def __repr__(self):
        return f"Raised({self.type}: {self.message})"


def mlp_fn(p, x):
    """The dict MLP of ``tests/parallel/test_data_parallel.py:_setup``."""
    return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]


class ConvNet(nn.Module):
    """The conv net of ``tests/parallel/test_data_parallel.py:_conv_setup``:
    conv 3@3x3 (SAME) → ReLU → flatten → Dense, on NHWC input."""

    def __init__(self, in_channels: int = 2, side: int = 6, features: int = 3,
                 num_classes: int = C):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, features, 3, padding=1)
        self.dense0 = nn.Linear(features * side * side, num_classes)
        self.flax_names = {"Conv_0": "conv0", "Dense_0": "dense0"}
        self.flax_flatten = {"Dense_0": (features, side, side)}

    def forward(self, x):
        return self.dense0(torch.relu(self.conv0(x.permute(0, 3, 1, 2))).flatten(1))


class ReplayedCE(vtt.CrossEntropyLoss):
    """Cross-entropy whose Monte-Carlo draws are given labels ``[N, M]``,
    indexed by global sample id (the JAX package's draws, replayed)."""

    def __init__(self, draws, reduction: str = "mean"):
        super().__init__(reduction)
        self._draws = torch.as_tensor(draws)

    def mc_draws(self, f, y, mc_samples, key, sample_ids):
        return self._draws[torch.as_tensor(list(sample_ids))].to(f.device)


@contextmanager
def recorded(owner, name):
    """Inside the block, every call of ``owner.name`` appends its result to
    the yielded list."""
    calls = []
    original = getattr(owner, name)

    def wrapper(*args, **kwargs):
        out = original(*args, **kwargs)
        calls.append(out)
        return out

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, original)


def to_numpy(x):
    """Tensors (in dicts, lists and tuples) as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x


class Rank:
    """What a case sees: its rank, the world size, the problems (numpy) and
    a singleton group of its own (``solo``, world size 1)."""

    def __init__(self, rank, k, data, solo):
        self.rank, self.k, self.data, self.solo = rank, k, data, solo

    def shard(self, a):
        n = a.shape[0] // self.k
        return torch.as_tensor(a[self.rank * n:(self.rank + 1) * n])

    def mlp(self):
        """``(params, X_l, y_l, X, y)`` of the dict MLP problem."""
        d = self.data["mlp"]
        params = {name: torch.tensor(v) for name, v in d["params"].items()}
        return (params, self.shard(d["X"]), self.shard(d["y"]),
                torch.tensor(d["X"]), torch.tensor(d["y"]))

    def module(self, name):
        """``(port module with the flax variables, X_l, y_l, X, y)``."""
        from vivit_tpu_torch.convert import load_flax
        from vivit_tpu_torch.models import MLP

        d = self.data[name]
        model = ConvNet() if d["kind"] == "conv" else MLP(D_IN, (H, C))
        load_flax(model, d["variables"])
        return (model.eval(), self.shard(d["X"]), self.shard(d["y"]),
                torch.tensor(d["X"]), torch.tensor(d["y"]))


def run_cases(rank, k, cases, data):
    """The rank side: every ``(name, case)`` in order, each ``case(Rank)``'s
    result as numpy, or :class:`Raised`.  Every rank runs every case, so
    the collectives line up."""
    import torch.distributed as dist

    solo = None
    for r in range(k):  # every rank creates every group, in the same order
        g = dist.new_group([r])
        if r == rank:
            solo = g
    ctx = Rank(rank, k, data, solo)
    out = {}
    for name, case in cases:
        try:
            out[name] = to_numpy(case(ctx))
        except Exception as exc:  # recorded for the test that reads it
            out[name] = Raised(exc)
    return out


def spawn_cases(cases, data):
    """Run ``cases`` (a dict name → function of :class:`Rank`) in a gloo
    group of ``K`` CPU ranks; a list of each rank's results."""
    from vivit_tpu_torch.parallel.launch import spawn

    return spawn(run_cases, K, (list(cases.items()), data), timeout=300)


def result(port, name, rank=0):
    """Rank ``rank``'s result of case ``name``; fails the test if it
    raised."""
    out = port[rank][name]
    if isinstance(out, Raised):
        raise AssertionError(f"case {name!r} raised on rank {rank}: {out}")
    return out


def rel_fro(got, want) -> float:
    """``‖got − want‖_F / ‖want‖_F`` in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def plain(tree):
    """A (frozen) nested dict of arrays as plain dicts of numpy arrays, so
    that the ranks can unpickle it without flax."""
    if hasattr(tree, "items"):
        return {k: plain(v) for k, v in tree.items()}
    return np.asarray(tree)


# ---- the pytest process only (JAX) -----------------------------------------


def jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:K]), ("data",))


def mlp_data():
    """The dict MLP problem (``_setup`` of the JAX tests) in numpy."""
    from tests.parallel.test_data_parallel import _setup

    _, params, X, y = _setup()
    return {"params": plain(params), "X": np.asarray(X), "y": np.asarray(y)}


def module_data(kind):
    """A flax problem of the JAX tests in numpy: ``"mlp"`` is
    ``MLP(features=(6, C))`` at ``PRNGKey(2)`` on ``default_rng(33)`` data,
    ``"conv"`` is ``_conv_setup()``.  Returns ``(flax module, variables,
    X, y, numpy data for the ranks)``."""
    import jax
    import jax.numpy as jnp

    if kind == "conv":
        from tests.parallel.test_data_parallel import _conv_setup

        module, variables, X, y = _conv_setup()
    else:
        from vivit_tpu.models import MLP

        module = MLP(features=(H, C))
        variables = module.init(jax.random.PRNGKey(2), jnp.ones((1, D_IN), jnp.float32))
        rng = np.random.default_rng(33)
        X = jnp.asarray(rng.normal(size=(N, D_IN)), jnp.float32)
        y = jnp.asarray(rng.integers(0, C, size=(N,)), jnp.int32)
    data = {"kind": kind, "variables": plain(variables), "X": np.asarray(X),
            "y": np.asarray(y)}
    return module, variables, X, y, data


def ce_draws(model_fn, params, X, y, mc, key):
    """The JAX package's Monte-Carlo labels ``[N, mc]`` of the global batch
    (its DP builders fold the global sample ids, as the single device
    does)."""
    import vivit_tpu as vt

    from tests.test_torch_port_ggn import jax_draws

    return jax_draws(vt.CrossEntropyLoss("mean"), model_fn, params, X, y, mc, key).numpy()
