"""Parity of the port's structured data-parallel builders
(``vivit_tpu_torch.parallel``: ``eigvalsh_dp_structured``,
``newton_step_dp_structured``) with the JAX package's, on the flax problems
of ``tests/parallel/test_data_parallel.py``: ``MLP(features=(6, 3))``
(Dense factors through ``all_gather``) and ``_conv_setup``'s conv net (the
tapped engine's conv blocks through ``all_to_all`` + ``all_reduce``),
loaded into the port with ``convert.load_flax``.

The port runs once for the file in a gloo group of 4 CPU ranks
(:mod:`tests.torch_dp`); the JAX builders run on a mesh of 4 CPU devices.
Bars (the JAX tests'): Grams ≤ 1e-6 relative Frobenius, eigenvalues rtol
1e-4 / atol 5e-6 (the sum reduction's atol 5e-5, as
``test_eigvalsh_dp_structured_sum_reduction``), steps rtol 1e-4 / atol
1e-6.
"""

import numpy as np
import pytest
import torch

import vivit_tpu_torch as vtt
from vivit_tpu_torch import parallel as par
from vivit_tpu_torch.structured import eigvalsh_structured

from tests import torch_dp
from tests.torch_dp import C, K, N, recorded, result, rel_fro

EV_RTOL, EV_ATOL = 1e-4, 5e-6
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
GRAM_BAR = 1e-6
CPU = dict(device="cpu")
SUB = [0, 3, 9, 14, 6]
CONV_SUB = [0, 3, 5, 8, 9, 12]


def _ce(reduction="mean"):
    return vtt.CrossEntropyLoss(reduction)


def _groups(model):
    names = [n for n, _ in model.named_parameters()]
    return [[n for n in names if n.endswith("weight")],
            [n for n in names if not n.endswith("weight")]]


def torch_damping(evals, evecs, gammas, lambdas):
    return 1.0 + 0.2 * lambdas.mean(dim=0)


# ---- the rank side (torch only) ---------------------------------------------


def _spectrum(r, name, loss=None, group=None, full=False, key=None, **kw):
    model, X_l, y_l, X, y = r.module(name)
    fn = par.eigvalsh_dp_structured(model, loss or _ce(), group, **CPU, **kw)
    return fn(X, y, key) if full else fn(X_l, y_l, key)


def _with_gram(r, name, **kw):
    with recorded(par, "_structured_gram_dp") as grams:
        evals = _spectrum(r, name, **kw)
    return {"evals": evals, "gram": grams[0]}


def case_mlp(r):
    return _with_gram(r, "mlp")


def case_mlp_sum(r):
    return _spectrum(r, "mlp", loss=_ce("sum"))


def case_mlp_mc(r):
    return _spectrum(r, "mlp", loss=torch_dp.ReplayedCE(r.data["draws"]), mc_samples=2,
                     key=7)


def case_mlp_groups_sub(r):
    model = r.module("mlp")[0]
    return _spectrum(r, "mlp", group_paths=_groups(model), subsampling=SUB)


def case_mlp_deflated(r):
    return _spectrum(r, "mlp", deflate_ce_null=True)


def case_mlp_engines_and_layouts(r):
    return {"vjp": _spectrum(r, "mlp", engine="vjp"),
            "k1": _spectrum(r, "mlp", group=r.solo, full=True)}


def case_conv(r):
    return _with_gram(r, "conv", engine="tapped")


def case_conv_sub_deflated(r):
    return _spectrum(r, "conv", subsampling=CONV_SUB, deflate_ce_null=True)


def case_conv_bf16(r):
    """bf16-stored conv blocks and bf16 Gram operands against the
    single-device pipeline with the same knobs."""
    model, _, _, X, y = r.module("conv")
    knobs = dict(conv_vt_dtype=torch.bfloat16, gram_precision="bf16")
    (single,) = eigvalsh_structured(model, _ce(), X, y, **knobs, **CPU)
    return {"dp": _spectrum(r, "conv", **knobs), "single": single}


def _newton(r, name, k=3, damping=1.0, **kw):
    model, X_l, y_l, _, _ = r.module(name)
    return par.newton_step_dp_structured(model, _ce(), None, k, damping, **CPU, **kw)(X_l, y_l)


def case_newton_mlp(r):
    return _newton(r, "mlp")


def case_newton_conv(r):
    return _newton(r, "conv", engine="tapped")


def case_newton_callable_dc(r):
    return _newton(r, "mlp", damping=torch_damping, solver="dc")


def case_newton_deflated(r):
    return _newton(r, "mlp", deflate_ce_null=True)


def case_newton_rank_guard(r):
    return _newton(r, "mlp", k=C * N + 1)


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}

_JAX = {}


def _problem(kind):
    """``(flax module, variables, X, y)``, built once per file."""
    if kind not in _JAX:
        _JAX[kind] = torch_dp.module_data(kind)
    return _JAX[kind]


@pytest.fixture(scope="module")
def port():
    data = {kind: _problem(kind)[4] for kind in ("mlp", "conv")}
    module, variables, X, y, _ = _problem("mlp")
    data["draws"] = torch_dp.ce_draws(lambda p, x: module.apply({"params": p}, x),
                                      variables["params"], X, y, 2, 7)
    return torch_dp.spawn_cases(CASES, data)


# ---- the JAX side (pytest process) ------------------------------------------


def _jax(builder, kind, *args, reduction="mean", key=None, **kw):
    import vivit_tpu as vt
    from vivit_tpu import parallel as jpar

    module, variables, X, y, _ = _problem(kind)
    fn = getattr(jpar, builder)(module, vt.CrossEntropyLoss(reduction), torch_dp.jax_mesh(),
                                *args, **kw)
    return fn(variables, X, y, key)


def _jax_gram(kind, engine):
    """The Gram ``eigvalsh_dp_structured`` solves, from the JAX package's
    own pieces."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import vivit_tpu as vt
    from vivit_tpu import parallel as jpar
    from vivit_tpu.structured import structured_ggn_sqrt_vt

    module, variables, X, y, _ = _problem(kind)
    loss = vt.CrossEntropyLoss("mean")

    def per_shard(variables, X_l, y_l):
        n_local = X_l.shape[0]
        ids = jax.lax.axis_index("data") * n_local + jnp.arange(n_local)
        v = structured_ggn_sqrt_vt(module, variables, loss, X_l, y_l, sample_ids=ids,
                                   engine=engine)
        rescale = jnp.sqrt(jnp.asarray(loss.rho(n_local * K) / loss.rho(n_local)))
        return jpar._structured_gram_dp(v, rescale, "data", None)

    fn = jax.jit(jax.shard_map(per_shard, mesh=torch_dp.jax_mesh(),
                               in_specs=(P(), P("data"), P("data")), out_specs=P(),
                               check_vma=False))
    return np.asarray(fn(variables, X, y))


def _assert_evals(got, want, atol=EV_ATOL):
    got, want = np.sort(np.asarray(got)), np.sort(np.asarray(want))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=EV_RTOL, atol=atol)


def _assert_step(got, kind, want):
    """The port's step (``named_parameters`` order) against the JAX
    package's params-shaped pytree, in the port's layout."""
    from vivit_tpu.utils.tree import flatten_with_paths

    from vivit_tpu_torch.convert import leaves_from_flax

    model = torch_dp.ConvNet() if kind == "conv" else vtt.models.MLP(torch_dp.D_IN,
                                                                       (torch_dp.H, C))
    want = leaves_from_flax({p: np.asarray(v)[None] for p, v in flatten_with_paths(want)},
                            model)
    names = [n for n, _ in model.named_parameters()]
    assert len(got) == len(names)
    for g, n in zip(got, names):
        np.testing.assert_allclose(g, want[n][0].numpy(), rtol=STEP_RTOL, atol=STEP_ATOL)


def test_conv_fixture_forward_matches_flax():
    """The port's twin of ``_conv_setup``'s conv net, after ``load_flax``."""
    from vivit_tpu_torch.convert import load_flax

    module, variables, X, _, data = _problem("conv")
    model = load_flax(torch_dp.ConvNet(), data["variables"]).eval()
    with torch.no_grad():
        got = model(torch.tensor(data["X"])).numpy()
    np.testing.assert_allclose(got, np.asarray(module.apply(variables, X)), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_structured_gram_matches_jax(port, kind):
    """Dense factors gathered, conv and generic blocks resharded: the Gram
    entry by entry, ``(rank, cf, n)``."""
    got = result(port, kind)["gram"]
    want = _jax_gram(kind, "tapped")
    assert got.shape == want.shape == (C * N, C * N)
    assert rel_fro(got, want) <= GRAM_BAR


def test_eigvalsh_dp_structured_matches_jax(port):
    _assert_evals(result(port, "mlp")["evals"], _jax("eigvalsh_dp_structured", "mlp"))


def test_eigvalsh_dp_structured_sum_reduction(port):
    _assert_evals(result(port, "mlp_sum"),
                  _jax("eigvalsh_dp_structured", "mlp", reduction="sum"), atol=5e-5)


def test_eigvalsh_dp_structured_mc_replays_jax_draws(port):
    import jax

    _assert_evals(result(port, "mlp_mc"),
                  _jax("eigvalsh_dp_structured", "mlp", mc_samples=2,
                       key=jax.random.PRNGKey(7)))


def test_eigvalsh_dp_structured_groups_and_subsampling(port):
    from vivit_tpu.utils.tree import leaf_paths

    module, variables, _, _, _ = _problem("mlp")
    paths = leaf_paths(variables["params"])
    groups = [[p for p in paths if p.endswith("kernel")],
              [p for p in paths if not p.endswith("kernel")]]
    want = _jax("eigvalsh_dp_structured", "mlp", group_paths=groups, subsampling=SUB)
    got = result(port, "mlp_groups_sub")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_evals(g, w)
        # (N − |S|)·C exact-zero padding rows below the spectrum
        assert np.allclose(np.sort(g)[:(N - len(SUB)) * C], 0.0, atol=1e-6)


def test_eigvalsh_dp_structured_deflated_matches_jax(port):
    got = result(port, "mlp_deflated")
    _assert_evals(got, _jax("eigvalsh_dp_structured", "mlp", deflate_ce_null=True))
    assert int((got == 0).sum()) == N


def test_eigvalsh_dp_structured_vjp_engine_and_world_size_one(port):
    """The vjp engine, and k = 1 (each rank alone, the whole batch), give
    the tapped k = 4 spectrum."""
    got = result(port, "mlp_engines_and_layouts")
    want = result(port, "mlp")["evals"]
    _assert_evals(got["vjp"], want)
    _assert_evals(got["k1"], want)


def test_eigvalsh_dp_structured_tapped_conv(port):
    _assert_evals(result(port, "conv")["evals"],
                  _jax("eigvalsh_dp_structured", "conv", engine="tapped"))


def test_eigvalsh_dp_structured_tapped_subsampling_deflate(port):
    """Conv blocks zero-masked in f32 and cast back, CE deflation."""
    got = np.sort(result(port, "conv_sub_deflated"))
    want = _jax("eigvalsh_dp_structured", "conv", engine="tapped", subsampling=CONV_SUB,
                deflate_ce_null=True)
    _assert_evals(got, want)
    assert np.allclose(got[:(N - len(CONV_SUB)) * C], 0.0, atol=1e-6)


def test_eigvalsh_dp_structured_conv_vt_dtype(port):
    got = result(port, "conv_bf16")
    _assert_evals(got["dp"], got["single"])


def test_newton_step_dp_structured_matches_jax(port):
    evals, step = result(port, "newton_mlp")
    want_ev, want = _jax("newton_step_dp_structured", "mlp", 3, 1.0)
    np.testing.assert_allclose(evals, np.asarray(want_ev), rtol=EV_RTOL, atol=EV_ATOL)
    _assert_step(step, "mlp", want)


def test_newton_step_dp_structured_tapped_conv(port):
    _, want = _jax("newton_step_dp_structured", "conv", 3, 1.0, engine="tapped")
    _assert_step(result(port, "newton_conv")[1], "conv", want)


def test_newton_step_dp_structured_damping_callable_and_solver(port):
    import jax.numpy as jnp

    def jax_damping(evals, evecs, gammas, lambdas):
        return 1.0 + 0.2 * jnp.mean(lambdas, axis=0)

    _, want = _jax("newton_step_dp_structured", "mlp", 3, jax_damping, solver="dc")
    _assert_step(result(port, "newton_callable_dc")[1], "mlp", want)


def test_newton_step_dp_structured_deflated(port):
    _, want = _jax("newton_step_dp_structured", "mlp", 3, 1.0, deflate_ce_null=True)
    _assert_step(result(port, "newton_deflated")[1], "mlp", want)


def test_newton_step_dp_structured_rank_guard(port):
    out = port[0]["newton_rank_guard"]
    assert isinstance(out, torch_dp.Raised) and "exceeds the Gram rank" in out.message, out


def test_newton_step_dp_structured_rejects_sum_reduction():
    with pytest.raises(ValueError, match="mean"):
        par.newton_step_dp_structured(torch_dp.ConvNet(), _ce("sum"), None, 2, **CPU)
