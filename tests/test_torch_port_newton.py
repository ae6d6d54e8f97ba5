"""Parity of the port's damped Newton step with the JAX package's, on
full-width CIFAR-10 3c3d at N=4-20: ``newton_step_structured`` end to end
with each solver, and its pieces ``batch_grad``, ``vt_mat_prod_mixed``,
``gammas_lambdas`` and ``deflated_eigh``.

Identical weights and inputs, made with numpy from a seed, go through both
packages; the JAX side runs on the CPU.  The Grams are f32 on both sides
(the JAX package's CPU "bf16" is full f32, ROADMAP §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vivit_tpu as vt
from vivit_tpu import deflate as jax_deflate
from vivit_tpu.ggn import batch_grad as jax_batch_grad
from vivit_tpu.models import CNN3c3d as FlaxCNN3c3d
from vivit_tpu.optim.utils import gammas_lambdas as jax_gammas_lambdas
from vivit_tpu.structured import newton_step_structured as jax_newton_step
from vivit_tpu.structured import vt_mat_prod_mixed as jax_vt_mat_prod_mixed
from vivit_tpu.tapped import tapped_ggn_sqrt_vt as jax_tapped
from vivit_tpu.utils.tree import leaf_paths

from tests.test_torch_port_eigh import _ce_gram
from vivit_tpu_torch import CNN3c3d, CrossEntropyLoss, Loss, batch_grad, newton_step_structured
from vivit_tpu_torch.convert import leaves_from_flax, params_from_flax
from vivit_tpu_torch.deflate import deflated_eigh
from vivit_tpu_torch.models import cnn3c3d_flax_params
from vivit_tpu_torch.optim.utils import gammas_lambdas
from vivit_tpu_torch.precision import full_f32
from vivit_tpu_torch.structured import vt_mat_prod_mixed
from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt

# BASELINE.md: the Newton step, γ and λ at rtol 1e-5; the step's atol
# 1e-5 and the lobpcg+deflate step's 7.7e-4 (the JAX package's recorded
# deviation), both scaled by max(max|oracle|, 1) as tests/test_engines.py does
NEWTON_RTOL, NEWTON_ATOL, LOBPCG_ATOL = 1e-5, 1e-5, 7.7e-4
RTOL, ATOL = 1e-4, 5e-6
VEC_RTOL, VEC_ATOL = 2e-2, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    params_np = cnn3c3d_flax_params(seed=0)
    flax_vars = {"params": jax.tree_util.tree_map(jnp.asarray, params_np)}
    model = CNN3c3d()
    model.load_state_dict(params_from_flax(params_np))
    return FlaxCNN3c3d(10), flax_vars, model.eval()


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(n,)).astype(np.int32)
    return X, y


def _port_paths(model):
    return [name for name, _ in model.named_parameters()]


def _to_port(fvars, leaves, stacked=True):
    """JAX leaves in ``leaf_paths`` order → ``{port name: tensor}``."""
    paths = leaf_paths(fvars["params"])
    arrays = [np.asarray(v) if stacked else np.asarray(v)[None] for v in leaves]
    out = leaves_from_flax(dict(zip(paths, arrays)))
    return out if stacked else {k: v[0] for k, v in out.items()}


@pytest.mark.parametrize("subsampling", [None, [5, 0, 3]], ids=["all", "subsampled"])
def test_batch_grad_matches_jax(models, subsampling):
    fmod, fvars, model = models
    X, y = _batch(6)
    loss_j = vt.CrossEntropyLoss("mean")
    want = jax.jit(lambda p, X, y: jax_batch_grad(
        lambda q, x: fmod.apply({"params": q}, x), loss_j, p, X, y,
        subsampling=subsampling))(fvars["params"], jnp.asarray(X), jnp.asarray(y))
    want = _to_port(fvars, jax.tree_util.tree_leaves(want))
    got = batch_grad(model, CrossEntropyLoss("mean"), torch.tensor(X), torch.tensor(y),
                     subsampling=subsampling)
    assert list(got) == _port_paths(model)
    for name, g in got.items():
        w = want[name].numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6 * np.abs(w).max())
    # batch_size sets the 1/N of the mean reduction
    half = batch_grad(model, CrossEntropyLoss("mean"), torch.tensor(X), torch.tensor(y),
                      subsampling=subsampling, batch_size=12)
    for name in got:
        np.testing.assert_allclose(half[name].numpy(), 0.5 * got[name].numpy(),
                                   rtol=1e-6, atol=1e-9)


def test_vt_mat_prod_mixed_matches_jax(models):
    """``Vᵀ m`` over every block type (factored Dense weights, ConvVT, bias
    tensors), ``m`` given in each package's layout."""
    fmod, fvars, model = models
    X, y = _batch(4)
    jvt = jax.jit(lambda v, X, y: jax_tapped(
        fmod, v, vt.CrossEntropyLoss("mean"), X, y))(fvars, jnp.asarray(X), jnp.asarray(y))
    with full_f32():
        pvt = tapped_ggn_sqrt_vt(model, CrossEntropyLoss("mean"), torch.tensor(X),
                                 torch.tensor(y))
    rng = np.random.default_rng(3)
    jpaths = leaf_paths(fvars["params"])
    mats = [rng.normal(size=(3, *np.shape(leaf))).astype(np.float32)
            for leaf in jax.tree_util.tree_leaves(fvars["params"])]
    want = np.asarray(jax_vt_mat_prod_mixed(jvt, [jnp.asarray(m) for m in mats], jpaths))
    port_mats = leaves_from_flax(dict(zip(jpaths, mats)))
    paths = _port_paths(model)
    with full_f32():
        got = vt_mat_prod_mixed(pvt, [port_mats[p] for p in paths], paths).numpy()
    assert got.shape == (40, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_gammas_lambdas_matches_jax():
    rng = np.random.default_rng(4)
    s, cf, n_grad, k = 6, 10, 5, 4
    cols = rng.normal(size=(cf * s, 80))
    gram = (cols @ cols.T).astype(np.float32)
    ev, vecs = np.linalg.eigh(gram.astype(np.float64))
    ev, vecs = ev[-k:].astype(np.float32), vecs[:, -k:].astype(np.float32)
    v_t_g = rng.normal(size=(cf * s, n_grad)).astype(np.float32)
    got = gammas_lambdas(*(torch.tensor(a) for a in (gram, ev, vecs, v_t_g)), s)
    want = jax_gammas_lambdas(*(jnp.asarray(a) for a in (gram, ev, vecs, v_t_g)), s)
    assert got[0].shape == (n_grad, k) and got[1].shape == (s, k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6 * np.abs(np.asarray(w)).max())


@pytest.mark.parametrize("backend", ["xla", "dc"])
def test_deflated_eigh_matches_jax(backend):
    """Full eigenpairs through the deflation: ``S`` exact zeros with the
    analytic null vectors, the rest lifted; (C−1)·S = 171, so ``"dc"`` runs
    the chain path in eigenvector mode."""
    s, c = 19, 10
    gram, p = _ce_gram(s, c, 400, seed=2)
    ev, vecs, info = deflated_eigh(torch.tensor(gram), torch.tensor(p), backend=backend,
                                   return_info=True)
    assert not bool(info["tripped"])
    ev_j, vecs_j = jax.jit(jax_deflate.deflated_eigh)(jnp.asarray(gram), jnp.asarray(p))
    ev, vecs = ev.numpy(), vecs.numpy()
    assert (ev[:s] == 0.0).all() and vecs.shape == (c * s, c * s)
    tol = ATOL * np.abs(ev_j).max() + RTOL * np.abs(np.asarray(ev_j))
    assert (np.abs(ev - np.asarray(ev_j)) <= tol).all()
    # the null block is analytic: the same vectors, in the same order
    np.testing.assert_allclose(vecs[:, :s], np.asarray(vecs_j)[:, :s], rtol=1e-6, atol=1e-7)
    top, top_j = vecs[:, -20:], np.asarray(vecs_j)[:, -20:]
    sign = np.sign(np.sum(top * top_j, axis=0, keepdims=True))
    np.testing.assert_allclose(top * sign, top_j, rtol=VEC_RTOL, atol=VEC_ATOL)
    np.testing.assert_allclose(vecs.T @ vecs, np.eye(c * s), atol=2e-5)


def _jax_step(models, X, y, **kw):
    fmod, fvars, _ = models
    step = jax.jit(lambda v, X, y: jax_newton_step(
        fmod, v, vt.CrossEntropyLoss("mean"), X, y, 10, **kw))(
        fvars, jnp.asarray(X), jnp.asarray(y))
    return _to_port(fvars, step, stacked=False)


def _assert_step(got, want, paths, atol):
    scale = max(max(float(w.abs().max()) for w in want.values()), 1.0)
    for name, g in zip(paths, got):
        w = want[name]
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=NEWTON_RTOL,
                                   atol=atol * scale, err_msg=name)


def _damping(evals, evecs, gammas, lambdas):
    """A per-direction damping that works on both packages' arrays."""
    return 0.5 + 0.1 * lambdas.mean(0)


NEWTON_CASES = {
    "eigh": (8, dict(solver="eigh"), NEWTON_ATOL),
    # (C−1)·S = 180 > 160: the dc solver's chain path in eigenvector mode
    "dc-deflated": (20, dict(solver="dc", deflate_ce_null=True), NEWTON_ATOL),
    "lobpcg-deflated": (8, dict(solver="lobpcg", deflate_ce_null=True), LOBPCG_ATOL),
    "callable-damping": (8, dict(solver="eigh", damping=_damping), NEWTON_ATOL),
    "subsampled": (8, dict(solver="eigh", subsampling_grad=[0, 2, 5],
                           subsampling_ggn=[7, 1, 3, 4, 6]), NEWTON_ATOL),
}


@pytest.mark.parametrize("case", list(NEWTON_CASES))
def test_newton_step_matches_jax(models, case):
    n, kw, atol = NEWTON_CASES[case]
    X, y = _batch(n, seed=1)
    want = _jax_step(models, X, y, **kw)
    model = models[2]
    got = newton_step_structured(model, CrossEntropyLoss("mean"), X, y, 10,
                                 device="cpu", **kw)
    _assert_step(got, want, _port_paths(model), atol)


@pytest.mark.parametrize("case", ["vjp", "mc", "function"])
def test_newton_step_engines_match_jax(models, case):
    """What needs the generic engine, on full-width 3c3d at N=6: the
    structured step with ``engine="vjp"`` and with Monte-Carlo factors
    (the JAX package's draws replayed) against the JAX package's, and
    ``newton_step_topk`` on a plain model function against the JAX
    package's function form."""
    from tests.test_torch_port_ggn import _Replay, jax_draws
    from vivit_tpu_torch import newton_step_topk
    from vivit_tpu_torch.engines import forward_fn, module_params

    fmod, fvars, model = models
    X, y = _batch(6, seed=3)
    jloss = vt.CrossEntropyLoss("mean")
    kw = dict(engine="vjp") if case == "vjp" else dict(mc_samples_ggn=2) if case == "mc" else {}
    if case == "function":
        want = jax.jit(lambda p, X, y: vt.newton_step_topk(
            lambda q, x: fmod.apply({"params": q}, x), jloss, p, X, y, 10, damping=0.5))(
            fvars["params"], jnp.asarray(X), jnp.asarray(y))
        got = newton_step_topk(forward_fn(model), CrossEntropyLoss("mean"), X, y, 10,
                               damping=0.5, params=module_params(model), device="cpu")
    else:
        want = jax.jit(lambda v, X, y, k: jax_newton_step(
            fmod, v, jloss, X, y, 10, damping=0.5, key=k, **kw))(
            fvars, jnp.asarray(X), jnp.asarray(y), jax.random.PRNGKey(2))
        loss = CrossEntropyLoss("mean")
        if case == "mc":
            loss = _Replay(loss, jax_draws(jloss, lambda p, x: fmod.apply({"params": p}, x),
                                           fvars["params"], jnp.asarray(X), jnp.asarray(y),
                                           2, 2))
        got = newton_step_structured(model, loss, X, y, 10, damping=0.5, key=2,
                                     device="cpu", **kw)
    _assert_step(got, _to_port(fvars, want, stacked=False), _port_paths(model), NEWTON_ATOL)


def test_newton_step_errors(models):
    model = models[2]
    X, y = _batch(2)
    args = (X, y, 2)
    with pytest.raises(ValueError, match="reduction='mean'"):
        newton_step_structured(model, CrossEntropyLoss("sum"), *args, device="cpu")
    with pytest.raises(ValueError, match="CrossEntropyLoss only"):
        newton_step_structured(model, Loss("mean"), *args, deflate_ce_null=True,
                               device="cpu")
    with pytest.raises(ValueError, match="exact factors"):
        newton_step_structured(model, CrossEntropyLoss(), *args, mc_samples_ggn=4,
                               deflate_ce_null=True, device="cpu")
    with pytest.raises(ValueError, match="key"):
        newton_step_structured(model, CrossEntropyLoss(), *args, mc_samples_ggn=4,
                               device="cpu")
    with pytest.raises(TypeError, match="newton_step_topk"):
        newton_step_structured(lambda p, x: x, CrossEntropyLoss(), *args, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        newton_step_structured(model, CrossEntropyLoss(), *args, engine="fast",
                               device="cpu")
