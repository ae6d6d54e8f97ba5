"""Parity of the port's V-transform engines with the JAX package, on every
problem of ``tests/implementation/cases.py``.

For each problem the JAX package's generic ``ggn_sqrt_vt`` Gram is the
reference; the port builds its Gram three ways: the generic engine over the
module's ``functional_call`` (a model function), the tapped engine (its fast
path plus the generic fallback for every other parameter) and the
structured ``engine="vjp"``.  The same weights (the problem's flax init,
converted) and the same numpy batch go through both packages; the JAX side
runs on the CPU.  Monte-Carlo factors are compared through the JAX
package's own draws, recovered from its factors and replayed into the port.
The matrix-free products are in ``tests/test_torch_port_products.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vivit_tpu as vt
from vivit_tpu.ggn import ggn_sqrt_vt as jax_ggn_sqrt_vt
from vivit_tpu.ggn import loss_hessian_sqrt as jax_loss_hessian_sqrt
from vivit_tpu.gram import gram_matrix as jax_gram_matrix

from tests.implementation.cases import PROBLEM_IDS, PROBLEMS, SUBSAMPLINGS
from tests.test_torch_port_models import port_problem
import vivit_tpu_torch as vtt
from vivit_tpu_torch.engines import forward_fn, module_params
from vivit_tpu_torch.ggn import ggn_sqrt_vt
from vivit_tpu_torch.gram import gram_matrix
from vivit_tpu_torch.precision import full_f32
from vivit_tpu_torch.structured import gram_matrix_mixed, structured_ggn_sqrt_vt

# Gram entries (BASELINE.md: f32 contractions): rtol 1e-5, atol 1e-6·max|G|
RTOL, ATOL = 1e-5, 1e-6
# ‖G_generic − G_tapped‖_F / ‖G_tapped‖_F: f32 summation noise; chip_smoke.py
# holds the full-width 3c3d Grams to the same bar
ENGINE_BAR = 1e-5
FORMS = ["function", "tapped", "vjp"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_gram(name, sub, mc=0, key=0):
    p = PROBLEMS[PROBLEM_IDS.index(name)]
    subsampling = None if sub is None else list(sub)

    @jax.jit
    def gram(params, X, y, k):
        return jax_gram_matrix(jax_ggn_sqrt_vt(p.model_fn, p.loss, params, X, y,
                                               subsampling=subsampling, mc_samples=mc,
                                               key=k))

    return np.asarray(gram(p.params, p.X, p.y, jax.random.PRNGKey(key)))


def _port_gram(model, loss, X, y, form, **kw):
    with full_f32():
        if form == "function":
            vt_ = ggn_sqrt_vt(forward_fn(model), loss, module_params(model), X, y, **kw)
            assert all(isinstance(v, torch.Tensor) for v in vt_.values())
            return gram_matrix(vt_).numpy()
        vt_ = structured_ggn_sqrt_vt(model, loss, X, y, engine=form, **kw)
        assert list(vt_) == list(module_params(model))
        return gram_matrix_mixed(vt_).numpy()


def _assert_gram(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("sub", SUBSAMPLINGS, ids=["full", "sub"])
@pytest.mark.parametrize("name", PROBLEM_IDS)
def test_gram_matches_jax(name, sub, form):
    want = _jax_gram(name, None if sub is None else tuple(sub))
    model, loss, X, y = port_problem(PROBLEMS[PROBLEM_IDS.index(name)])
    _assert_gram(_port_gram(model, loss, X, y, form, subsampling=sub), want)


def test_generic_and_tapped_engines_agree_3c3d():
    """The engine-agreement bar of the chip smoke, at full 3c3d width on 3
    samples: the generic and the tapped 30² Grams (f32)."""
    from vivit_tpu_torch.convert import params_from_flax
    from vivit_tpu_torch.models import cnn3c3d_flax_params

    model = vtt.CNN3c3d()
    model.load_state_dict(params_from_flax(cnn3c3d_flax_params(seed=0)))
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.normal(size=(3, 32, 32, 3)).astype(np.float32))
    y = torch.tensor(rng.integers(0, 10, size=(3,)))
    loss = vtt.CrossEntropyLoss("mean")
    g_fn = torch.tensor(_port_gram(model.eval(), loss, X, y, "function"))
    g_tap = torch.tensor(_port_gram(model, loss, X, y, "tapped"))
    assert ((g_fn - g_tap).norm() / g_tap.norm()).item() <= ENGINE_BAR


class _Replay:
    """A port loss that replays given Monte-Carlo draws, indexed by global
    sample id, in place of its own."""

    def __init__(self, loss, draws):
        self._loss, self._draws = loss, draws

    def __getattr__(self, name):
        return getattr(self._loss, name)

    def mc_draws(self, f, y, mc_samples, key, sample_ids):
        return self._draws[torch.as_tensor(list(sample_ids))]

    def __call__(self, f, y):
        return self._loss(f, y)


def jax_draws(problem_loss, model_fn, params, X, y, mc, key):
    """The JAX package's MC draws of every sample, recovered from its
    (unscaled) factors: MSE ``ε = s/√(h/M)``, CE ``label = argmax(p − √M·s)``."""
    f = model_fn(params, X)
    s = np.asarray(jax_loss_hessian_sqrt(problem_loss, f, y, mc_samples=mc,
                                         key=jax.random.PRNGKey(key),
                                         sample_ids=jnp.arange(X.shape[0])))
    if isinstance(problem_loss, vt.MSELoss):
        h = problem_loss._h(s.shape[-1])
        return torch.tensor(s / np.sqrt(h / mc))
    p = np.asarray(jax.nn.softmax(f, axis=-1))
    return torch.tensor(np.argmax(p[:, None, :] - np.sqrt(mc) * s, axis=-1))


def replayed(problem, loss, mc, key):
    return _Replay(loss, jax_draws(problem.loss, problem.model_fn, problem.params,
                                   problem.X, problem.y, mc, key))


MC_PROBLEMS = ["mlp_CrossEntropyLoss_mean", "mlp_MSELoss_sum", "cnn_ce_mean",
               "convtranspose_mse_mean", "kitchensink_ce_mean"]


@pytest.mark.parametrize("form", ["function", "tapped"])
@pytest.mark.parametrize("sub", SUBSAMPLINGS, ids=["full", "sub"])
@pytest.mark.parametrize("name", MC_PROBLEMS)
def test_mc_gram_matches_jax_draws(name, sub, form):
    problem = PROBLEMS[PROBLEM_IDS.index(name)]
    want = _jax_gram(name, None if sub is None else tuple(sub), mc=3, key=11)
    model, loss, X, y = port_problem(problem)
    loss = replayed(problem, loss, 3, 11)
    _assert_gram(_port_gram(model, loss, X, y, form, subsampling=sub, mc_samples=3,
                            key=11), want)


def test_mc_draws_follow_key_and_sample_id():
    """The port's own draws: a function of (key, global sample id) only, so
    the same key repeats them bit for bit, a sub-batch gets the full batch's
    columns for its samples (up to the column scale), and another key
    changes them."""
    problem = PROBLEMS[PROBLEM_IDS.index("cnn_ce_mean")]
    model, loss, X, y = port_problem(problem)
    fn, params = forward_fn(model), module_params(model)
    with full_f32():
        a = ggn_sqrt_vt(fn, loss, params, X, y, mc_samples=2, key=5)
        b = ggn_sqrt_vt(fn, loss, params, X, y, mc_samples=2, key=5)
        sub = ggn_sqrt_vt(fn, loss, params, X, y, mc_samples=2, key=5, subsampling=[3, 1])
        other = ggn_sqrt_vt(fn, loss, params, X, y, mc_samples=2, key=6)
    n = X.shape[0]
    for name in a:
        assert torch.equal(a[name], b[name])
        torch.testing.assert_close(sub[name], a[name][:, [3, 1]] * (n / 2) ** 0.5,
                                   rtol=1e-5, atol=1e-7)
    assert any(not torch.equal(a[k], other[k]) for k in a)
    with pytest.raises(ValueError, match="key"):
        ggn_sqrt_vt(fn, loss, params, X, y, mc_samples=2)
