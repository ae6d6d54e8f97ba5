"""Parity of the port's ``optim`` API (module form) with the JAX package's,
on a small conv net (the ``TinyConvNet`` of ``tests/test_engines.py``):
``newton_step_topk``, ``directional_derivatives_topk``,
``DirectionalDerivativesComputation`` and
``DirectionalDampedNewtonComputation``, the criteria, and the error paths.

The same flax weights, converted to the PyTorch layout, and the same numpy
batch go through both packages; the JAX side runs on the CPU.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import vivit_tpu as vt
from vivit_tpu.utils.tree import leaf_paths

import vivit_tpu_torch as vtt
from vivit_tpu_torch.engines import forward_fn, module_params
from vivit_tpu_torch.linalg.utils import keep_all, keep_nonzero, keep_top_k

C = 3
# BASELINE.md: γ rtol 1e-5 / atol 1e-4, λ and the Newton step rtol 1e-5 /
# atol 1e-5; eigenvalues rtol 1e-4 / atol 5e-6
GAMMA_TOL, LAMBDA_TOL, STEP_TOL = (1e-5, 1e-4), (1e-5, 1e-5), (1e-5, 1e-5)
EV_RTOL, EV_ATOL = 1e-4, 5e-6
# flax leaf path → port parameter name
NAMES = {"Conv_0/kernel": "conv.weight", "Conv_0/bias": "conv.bias",
         "Dense_0/kernel": "dense0.weight", "Dense_0/bias": "dense0.bias",
         "Dense_1/kernel": "dense1.weight", "Dense_1/bias": "dense1.bias"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FlaxTinyConvNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = fnn.relu(fnn.Conv(4, (3, 3))(x))
        x = x.reshape((x.shape[0], -1))
        x = fnn.relu(fnn.Dense(8)(x))
        return fnn.Dense(C)(x)


class TinyConvNet(nn.Module):
    """The flax net in PyTorch: NHWC input, SAME-padded conv, flatten in
    ``(h, w, c)`` order."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 4, 3, padding=1)
        self.dense0 = nn.Linear(6 * 6 * 4, 8)
        self.dense1 = nn.Linear(8, C)

    def forward(self, x):
        x = torch.relu(self.conv(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        return self.dense1(torch.relu(self.dense0(x.flatten(1))))


def _port_layout(path, a):
    """One flax leaf (or a ``[K, ...]`` stack of them) in the port's layout."""
    a = np.asarray(a, np.float32)
    if path.startswith("Conv") and path.endswith("kernel"):  # [kh, kw, I, O] → [O, I, kh, kw]
        a = np.moveaxis(a, (-1, -2, -4, -3), (-4, -3, -2, -1))
    elif path.endswith("kernel"):  # [in, out] → [out, in]
        a = np.swapaxes(a, -1, -2)
    return torch.tensor(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def setup():
    fmod = FlaxTinyConvNet()
    variables = fmod.init(jax.random.PRNGKey(0), jnp.ones((1, 6, 6, 2), jnp.float32))
    params = variables["params"]
    model = TinyConvNet()
    model.load_state_dict({NAMES[p]: _port_layout(p, leaf) for p, leaf in zip(
        leaf_paths(params), jax.tree_util.tree_leaves(params))})
    rng = np.random.default_rng(7)
    X = rng.normal(size=(12, 6, 6, 2)).astype(np.float32)
    y = rng.integers(0, C, size=(12,)).astype(np.int32)
    return fmod, variables, model, X, y


def _model_fn(fmod):
    return lambda p, x: fmod.apply({"params": p}, x)


def _assert_close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol[0],
                               atol=tol[1] * max(np.abs(want).max(), 1.0))


def _assert_gammas(got, want):
    """γ up to the sign of each direction."""
    got, want = np.asarray(got), np.asarray(want)
    sign = np.sign(np.sum(got * want, axis=0, keepdims=True))
    _assert_close(got * sign, want, GAMMA_TOL)


def _assert_evals(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = EV_ATOL * np.abs(want).max() + EV_RTOL * np.abs(want)
    assert (np.abs(got - want) <= tol).all()


def _assert_steps(got, want, jax_paths, atol=STEP_TOL[1]):
    """Port step (group order, port names) against the JAX step (group
    order, flax paths), at the Newton bar (``atol`` scaled by
    max(max|want|, 1))."""
    assert len(got) == len(want) == len(jax_paths)
    scale = max(max(float(np.abs(np.asarray(w)).max()) for w in want), 1.0)
    for g, w, p in zip(got, want, jax_paths):
        w = _port_layout(p, w).numpy()
        assert g.shape == w.shape, p
        np.testing.assert_allclose(g.numpy(), w, rtol=STEP_TOL[0], atol=atol * scale,
                                   err_msg=p)


@pytest.mark.parametrize("solver,deflate", [("eigh", False), ("lobpcg", True)])
def test_newton_step_topk_matches_jax(setup, solver, deflate):
    fmod, variables, model, X, y = setup
    want = jax.jit(lambda p, X, y: vt.newton_step_topk(
        _model_fn(fmod), vt.CrossEntropyLoss("mean"), p, X, y, 4, damping=0.5,
        solver=solver, deflate_ce_null=deflate))(
        variables["params"], jnp.asarray(X), jnp.asarray(y))
    got = vtt.newton_step_topk(model, vtt.CrossEntropyLoss("mean"), X, y, 4,
                               damping=0.5, solver=solver, deflate_ce_null=deflate,
                               paths=[NAMES[p] for p in leaf_paths(variables["params"])],
                               device="cpu")
    # the two LOBPCG start blocks differ (torch.Generator against
    # jax.random): the lobpcg step is held at the recorded 7.7e-4 bar
    _assert_steps(got, want, leaf_paths(variables["params"]),
                  atol=7.7e-4 if solver == "lobpcg" else STEP_TOL[1])


def test_directional_derivatives_topk_matches_jax(setup):
    fmod, variables, model, X, y = setup
    kw = dict(subsampling_grad=[0, 4, 9], subsampling_ggn=[1, 2, 3, 5, 6, 8, 10, 11])
    ev_j, g_j, l_j = jax.jit(lambda p, X, y: vt.directional_derivatives_topk(
        _model_fn(fmod), vt.CrossEntropyLoss("mean"), p, X, y, 3, **kw))(
        variables["params"], jnp.asarray(X), jnp.asarray(y))
    ev, g, lam = vtt.directional_derivatives_topk(
        model, vtt.CrossEntropyLoss("mean"), X, y, 3, device="cpu", **kw)
    assert g.shape == (3, 3) and lam.shape == (8, 3)
    _assert_evals(ev, ev_j)
    _assert_gammas(g, g_j)
    _assert_close(lam, l_j, LAMBDA_TOL)


def _groups(variables, split):
    """Parameter groups in both naming schemes: one group of all leaves, or
    the conv leaves apart from the dense ones."""
    paths = leaf_paths(variables["params"])
    parts = ([paths] if not split else
             [[p for p in paths if p.startswith("Conv")],
              [p for p in paths if p.startswith("Dense")]])
    return parts, [[NAMES[p] for p in part] for part in parts]


@pytest.mark.parametrize("split", [False, True], ids=["one-group", "two-groups"])
def test_directional_derivatives_class_matches_jax(setup, split):
    fmod, variables, model, X, y = setup
    jparts, pparts = _groups(variables, split)
    want = vt.DirectionalDerivativesComputation(fmod, vt.CrossEntropyLoss("mean")).compute(
        variables, jnp.asarray(X), jnp.asarray(y),
        [{"params": p, "criterion": keep_top_k(3)} for p in jparts])
    comp = vtt.DirectionalDerivativesComputation(model, vtt.CrossEntropyLoss("mean"),
                                                 device="cpu")
    groups = [{"params": p, "criterion": keep_top_k(3)} for p in pparts]
    got = comp.compute(X, y, groups)
    for (g, lam), (g_j, l_j), group in zip(got, want, groups):
        _assert_gammas(g, g_j)
        _assert_close(lam, l_j, LAMBDA_TOL)
        assert comp.get_result(group)[0] is g


@pytest.mark.parametrize("split", [False, True], ids=["one-group", "two-groups"])
def test_damped_newton_class_matches_jax(setup, split):
    fmod, variables, model, X, y = setup
    jparts, pparts = _groups(variables, split)
    damping = vt.constant_damping(0.7)
    want = vt.DirectionalDampedNewtonComputation(fmod, vt.CrossEntropyLoss("mean")).compute(
        variables, jnp.asarray(X), jnp.asarray(y),
        [{"params": p, "criterion": keep_top_k(4), "damping": damping} for p in jparts])
    comp = vtt.DirectionalDampedNewtonComputation(model, vtt.CrossEntropyLoss("mean"),
                                                  device="cpu")
    groups = [{"params": p, "criterion": keep_top_k(4),
               "damping": vtt.constant_damping(0.7)} for p in pparts]
    got = comp.compute(X, y, groups)
    for step, step_j, group, jpaths in zip(got, want, groups, jparts):
        _assert_steps(step, step_j, jpaths)
        assert comp.get_result(group) is step


@pytest.mark.parametrize("solver", ["lobpcg", "dc"])
def test_damped_newton_class_top_k_solvers(setup, solver):
    """``solver``/``k_top`` with CE deflation against the JAX class with
    the same knobs (lobpcg at its recorded 7.7e-4 bar, as
    tests/test_engines.py holds the JAX package's), and ``eig_backend="dc"``
    with the full deflated eigendecomposition."""
    fmod, variables, model, X, y = setup
    jparts, pparts = _groups(variables, False)
    kw = dict(solver=solver, k_top=4, deflate_ce_null=True)
    want = vt.DirectionalDampedNewtonComputation(
        fmod, vt.CrossEntropyLoss("mean"), **kw).compute(
        variables, jnp.asarray(X), jnp.asarray(y),
        [{"params": jparts[0], "criterion": keep_all, "damping": vt.constant_damping(1.0)}])
    got = vtt.DirectionalDampedNewtonComputation(
        model, vtt.CrossEntropyLoss("mean"), device="cpu", **kw).compute(
        X, y, [{"params": pparts[0], "criterion": keep_all,
                "damping": vtt.constant_damping(1.0)}])
    _assert_steps(got[0], want[0], jparts[0],
                  atol=7.7e-4 if solver == "lobpcg" else STEP_TOL[1])

    full = vtt.DirectionalDampedNewtonComputation(
        model, vtt.CrossEntropyLoss("mean"), eig_backend="dc", deflate_ce_null=True,
        device="cpu").compute(X, y, [{"params": pparts[0], "criterion": keep_top_k(4),
                                      "damping": vtt.constant_damping(1.0)}])
    want_full = vt.DirectionalDampedNewtonComputation(
        fmod, vt.CrossEntropyLoss("mean"), deflate_ce_null=True).compute(
        variables, jnp.asarray(X), jnp.asarray(y),
        [{"params": jparts[0], "criterion": keep_top_k(4),
          "damping": vt.constant_damping(1.0)}])
    _assert_steps(full[0], want_full[0], jparts[0])


def test_criteria_match_jax():
    from vivit_tpu.linalg import utils as jax_utils

    ev = np.array([-1e-9, 0.0, 3e-8, 0.5, 2.0, 7.0], np.float32)
    assert keep_all(ev) == jax_utils.keep_all(ev)
    for k, floor in ((2, 0.0), (10, 0.0), (3, 1.0), (0, 0.0)):
        assert keep_top_k(k, floor)(ev) == jax_utils.keep_top_k(k, floor)(ev)
    assert keep_nonzero()(ev) == jax_utils.keep_nonzero()(ev) == [3, 4, 5]


def test_class_error_paths(setup):
    _, _, model, X, y = setup
    loss = vtt.CrossEntropyLoss("mean")
    names = [name for name, _ in model.named_parameters()]
    newton = vtt.DirectionalDampedNewtonComputation(model, loss, device="cpu")
    damping = vtt.constant_damping()
    with pytest.raises(ValueError, match="'damping' entry are required"):
        newton.compute(X, y, None)
    with pytest.raises(ValueError, match="does not specify 'damping'"):
        newton.compute(X, y, [{"params": names, "criterion": keep_all}])
    with pytest.raises(ValueError, match="more than one group"):
        newton.compute(X, y, [
            {"params": names[:3], "criterion": keep_all, "damping": damping},
            {"params": names[2:], "criterion": keep_all, "damping": damping}])
    with pytest.raises(ValueError, match="unknown parameter"):
        newton.compute(X, y, [{"params": ["conv.kernel"], "criterion": keep_all,
                               "damping": damping}])
    with pytest.raises(KeyError, match="No results"):
        newton.get_result({"params": names})
    with pytest.raises(ValueError, match="requires k_top"):
        vtt.DirectionalDampedNewtonComputation(model, loss, solver="lobpcg")
    derivs = vtt.DirectionalDerivativesComputation(model, loss, device="cpu")
    with pytest.raises(KeyError, match="No results"):
        derivs.get_result({"params": names})
    with pytest.raises(ValueError, match="does not specify 'criterion'"):
        derivs.compute(X, y, [{"params": names}])
    with pytest.raises(ValueError, match="unique"):
        vtt.DirectionalDerivativesComputation(model, loss, subsampling_grad=[1, 1])
    # the model forms: a function needs its params, a module brings its own
    with pytest.raises(ValueError, match="needs params="):
        vtt.DirectionalDerivativesComputation(lambda p, x: x, loss, device="cpu").compute(
            X, y, None)
    with pytest.raises(ValueError, match="brings its own parameters"):
        vtt.newton_step_topk(model, loss, X, y, 2, params=module_params(model), device="cpu")
    with pytest.raises(ValueError, match="key"):
        vtt.newton_step_topk(model, loss, X, y, 2, mc_samples_ggn=3, device="cpu")
    # with param_groups=None the derivatives class keeps every direction
    (g, lam), = derivs.compute(X, y, None)
    assert g.shape == (12, 36) and lam.shape == (12, 36)


def test_function_form_matches_jax(setup):
    """A plain model function with its params dict (the generic engine)
    against the JAX package's function form: ``newton_step_topk`` and both
    classes."""
    fmod, variables, model, X, y = setup
    fn, params = forward_fn(model), module_params(model)
    jparts, pparts = _groups(variables, True)
    want = jax.jit(lambda p, X, y: vt.newton_step_topk(
        _model_fn(fmod), vt.CrossEntropyLoss("mean"), p, X, y, 3, damping=0.5))(
        variables["params"], jnp.asarray(X), jnp.asarray(y))
    got = vtt.newton_step_topk(fn, vtt.CrossEntropyLoss("mean"), X, y, 3, damping=0.5,
                               params=params, device="cpu",
                               paths=[NAMES[p] for p in leaf_paths(variables["params"])])
    _assert_steps(got, want, leaf_paths(variables["params"]))

    jgroups = [{"params": p, "criterion": keep_top_k(3)} for p in jparts]
    pgroups = [{"params": p, "criterion": keep_top_k(3)} for p in pparts]
    want = vt.DirectionalDerivativesComputation(
        _model_fn(fmod), vt.CrossEntropyLoss("mean")).compute(
        variables["params"], jnp.asarray(X), jnp.asarray(y), jgroups)
    got = vtt.DirectionalDerivativesComputation(fn, vtt.CrossEntropyLoss("mean"),
                                                device="cpu").compute(X, y, pgroups,
                                                                      params=params)
    for (g, lam), (g_j, l_j) in zip(got, want):
        _assert_gammas(g, g_j)
        _assert_close(lam, l_j, LAMBDA_TOL)

    damping = vt.constant_damping(0.7)
    want = vt.DirectionalDampedNewtonComputation(
        _model_fn(fmod), vt.CrossEntropyLoss("mean")).compute(
        variables["params"], jnp.asarray(X), jnp.asarray(y),
        [dict(g, damping=damping) for g in jgroups])
    got = vtt.DirectionalDampedNewtonComputation(
        fn, vtt.CrossEntropyLoss("mean"), self_check=True, device="cpu").compute(
        X, y, [dict(g, damping=vtt.constant_damping(0.7)) for g in pgroups], params=params)
    for step, step_j, jpaths in zip(got, want, jparts):
        _assert_steps(step, step_j, jpaths)


def test_mc_samples_ggn_matches_jax(setup):
    """Monte-Carlo GGN factors: the JAX package's draws replayed into the
    port (``newton_step_topk`` and the derivatives class)."""
    from tests.test_torch_port_ggn import _Replay, jax_draws

    fmod, variables, model, X, y = setup
    jloss = vt.CrossEntropyLoss("mean")
    sub = [1, 2, 3, 5, 6, 8, 10, 11]
    draws = jax_draws(jloss, _model_fn(fmod), variables["params"], jnp.asarray(X),
                      jnp.asarray(y), 2, 9)
    loss = _Replay(vtt.CrossEntropyLoss("mean"), draws)
    want = jax.jit(lambda p, X, y, k: vt.newton_step_topk(
        _model_fn(fmod), jloss, p, X, y, 3, damping=0.5, mc_samples_ggn=2, key=k,
        subsampling_ggn=sub))(variables["params"], jnp.asarray(X), jnp.asarray(y),
                              jax.random.PRNGKey(9))
    got = vtt.newton_step_topk(model, loss, X, y, 3, damping=0.5, mc_samples_ggn=2, key=9,
                               subsampling_ggn=sub, device="cpu",
                               paths=[NAMES[p] for p in leaf_paths(variables["params"])])
    _assert_steps(got, want, leaf_paths(variables["params"]))

    jparts, pparts = _groups(variables, False)
    want = vt.DirectionalDerivativesComputation(fmod, jloss, mc_samples_ggn=2).compute(
        variables, jnp.asarray(X), jnp.asarray(y),
        [{"params": jparts[0], "criterion": keep_top_k(3)}], key=jax.random.PRNGKey(9))
    got = vtt.DirectionalDerivativesComputation(model, loss, mc_samples_ggn=2,
                                                device="cpu").compute(
        X, y, [{"params": pparts[0], "criterion": keep_top_k(3)}], key=9)
    _assert_gammas(got[0][0], want[0][0])
    _assert_close(got[0][1], want[0][1], LAMBDA_TOL)


def test_vjp_engine_matches_jax(setup):
    """``engine="vjp"`` (the generic engine with factored Linear weights)
    against the JAX class on the flax module with the same engine."""
    fmod, variables, model, X, y = setup
    jparts, pparts = _groups(variables, True)
    want = vt.DirectionalDampedNewtonComputation(
        fmod, vt.CrossEntropyLoss("mean"), engine="vjp").compute(
        variables, jnp.asarray(X), jnp.asarray(y),
        [{"params": p, "criterion": keep_top_k(4), "damping": vt.constant_damping(0.7)}
         for p in jparts])
    got = vtt.DirectionalDampedNewtonComputation(
        model, vtt.CrossEntropyLoss("mean"), engine="vjp", device="cpu").compute(
        X, y, [{"params": p, "criterion": keep_top_k(4),
                "damping": vtt.constant_damping(0.7)} for p in pparts])
    for step, step_j, jpaths in zip(got, want, jparts):
        _assert_steps(step, step_j, jpaths)
