"""Parity of the port's Gram primitives (``vivit_tpu_torch.extensions``) with
the JAX package's ``vivit_tpu.extensions``, mirroring ``tests/extensions/``
on the problems of ``tests/implementation/cases.py``.

The same weights (each problem's flax init, converted) and the same numpy
batch go through both packages; the JAX side is jitted on the CPU.  Grams
are compared at the JAX tests' bars (rtol 1e-5, atol 1e-7); per-sample
gradients are converted to the port's layout first.  ``layerwise`` dicts
are keyed by the port's parameter names, mapped from the JAX paths through
the converter.  Monte-Carlo Grams replay the JAX package's draws.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from vivit_tpu import extensions as jax_ext

from tests.implementation.cases import PROBLEM_IDS, PROBLEMS
from tests.test_torch_port_ggn import replayed
from tests.test_torch_port_models import port_problem
from vivit_tpu_torch import extensions as ext
from vivit_tpu_torch.convert import _leaf_target, leaves_from_flax
from vivit_tpu_torch.engines import forward_fn, module_params
from vivit_tpu_torch.ggn import ggn_sqrt_vt
from vivit_tpu_torch.gram import gram_matrix, reshape_as_square
from vivit_tpu_torch.precision import full_f32

RTOL, ATOL = 1e-5, 1e-7
# centered per-sample gradients: atol 1e-6 of the leaf's largest entry
GRAD_ATOL = 1e-6
FORMS = ["module", "function"]
MC_PROBLEMS = ["mlp_CrossEntropyLoss_mean", "mlp_MSELoss_sum", "cnn_ce_mean"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(name):
    return PROBLEMS[PROBLEM_IDS.index(name)]


def _call(fn, form, model, loss, X, y, *args, **kw):
    """``fn`` in one of the two model forms, on the CPU."""
    if form == "module":
        return fn(model, loss, X, y, *args, device="cpu", **kw)
    return fn(forward_fn(model), loss, X, y, *args, params=module_params(model),
              device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _jax(name, fn_name, **kw):
    """The JAX package's result, jitted; an int ``key`` becomes a PRNGKey."""
    p = _problem(name)
    fn = getattr(jax_ext, fn_name)
    if "key" in kw:
        kw["key"] = jax.random.PRNGKey(kw["key"])
    out = jax.jit(lambda params, X, y: fn(p.model_fn, p.loss, params, X, y, **kw))(
        p.params, p.X, p.y)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_name(model, path):
    return _leaf_target(model, *path.split("/"))[0]


def _assert_close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("center", [False, True], ids=["plain", "centered"])
@pytest.mark.parametrize("name", PROBLEM_IDS)
def test_gram_batch_grad_matches_jax(name, center):
    model, loss, X, y = port_problem(_problem(name))
    want = _jax(name, "gram_batch_grad", center=center)
    form = FORMS[PROBLEM_IDS.index(name) % 2]  # both forms over the problems
    _assert_close(_call(ext.gram_batch_grad, form, model, loss, X, y, center=center), want)


@pytest.mark.parametrize("form", FORMS)
def test_centered_gram_batch_grad_layerwise(form):
    """``centered_gram_batch_grad(layerwise=True)``: the total and every
    per-parameter Gram against the JAX package's, keys mapped."""
    name = "cnn_ce_mean"
    model, loss, X, y = port_problem(_problem(name))
    want_total, want_leaves = _jax(name, "centered_gram_batch_grad", layerwise=True)
    total, leaves = _call(ext.centered_gram_batch_grad, form, model, loss, X, y,
                          layerwise=True)
    _assert_close(total, want_total)
    assert set(leaves) == set(module_params(model))
    for path, want in want_leaves.items():
        _assert_close(leaves[_port_name(model, path)], want)


@pytest.mark.parametrize("name", ["mlp_CrossEntropyLoss_mean", "mlp_MSELoss_sum",
                                  "batchnorm_ce_mean"])
def test_centered_batch_grad_matches_jax(name):
    problem = _problem(name)
    model, loss, X, y = port_problem(problem)
    want = _jax(name, "centered_batch_grad")
    got = ext.centered_batch_grad(model, loss, X, y, device="cpu")
    want_port = leaves_from_flax(
        {path: want_leaf for path, want_leaf in zip(
            problem.paths, jax.tree_util.tree_leaves(want))}, model)
    assert list(got) == list(module_params(model))
    for k, g in got.items():
        # centering cancels: f32 noise relative to the leaf's scale
        scale = want_port[k].abs().max().item()
        np.testing.assert_allclose(g.numpy(), want_port[k].numpy(), rtol=RTOL,
                                   atol=GRAD_ATOL * scale)
        np.testing.assert_allclose(g.mean(dim=0).numpy(), 0.0, atol=GRAD_ATOL * scale)


@pytest.mark.parametrize("name", PROBLEM_IDS)
def test_gram_sqrt_ggn_matches_jax(name):
    model, loss, X, y = port_problem(_problem(name))
    want = _jax(name, "gram_sqrt_ggn")
    form = FORMS[(PROBLEM_IDS.index(name) + 1) % 2]
    got = _call(ext.gram_sqrt_ggn, form, model, loss, X, y)
    assert got.dim() == 4
    _assert_close(got, want)


@pytest.mark.parametrize("name", MC_PROBLEMS)
def test_gram_sqrt_ggn_mc_replays_jax_draws(name):
    problem = _problem(name)
    model, loss, X, y = port_problem(problem)
    want_total, want_leaves = _jax(name, "gram_sqrt_ggn", mc_samples=3,
                                   key=11, layerwise=True)
    total, leaves = ext.gram_sqrt_ggn(model, replayed(problem, loss, 3, 11), X, y,
                                      mc_samples=3, key=11, layerwise=True, device="cpu")
    # the replayed draws are recovered from the JAX factors, a rounding off:
    # the MC bar of tests/test_torch_port_ggn.py, atol 1e-6·max|G|
    _assert_close(total, want_total, atol=1e-6 * np.abs(want_total).max())
    for path, want in want_leaves.items():
        _assert_close(leaves[_port_name(model, path)], want,
                      atol=1e-6 * np.abs(want).max())


def test_gram_sqrt_ggn_is_the_generic_gram():
    """Flattened by ``reshape_as_square``, the ``[CF, N, CF, N]`` tensor is
    the port's generic ``gram_matrix ∘ ggn_sqrt_vt``."""
    model, loss, X, y = port_problem(_problem("kitchensink_ce_mean"))
    gram4 = ext.gram_sqrt_ggn(model, loss, X, y, device="cpu")
    with full_f32():
        gram2 = gram_matrix(ggn_sqrt_vt(forward_fn(model), loss, module_params(model),
                                        X, y))
    np.testing.assert_allclose(reshape_as_square(gram4).numpy(), gram2.numpy(),
                               rtol=1e-5, atol=1e-7)


def test_gram_batch_grad_scaling():
    """BackPACK's ρ: the mean-reduced Gram is the sum-reduced one over N²."""
    model, loss, X, y = port_problem(_problem("mlp_CrossEntropyLoss_mean"))
    _, sum_loss, _, _ = port_problem(_problem("mlp_CrossEntropyLoss_sum"))
    n = X.shape[0]
    mean = ext.gram_batch_grad(model, loss, X, y, device="cpu")
    total = ext.gram_batch_grad(model, sum_loss, X, y, device="cpu")
    np.testing.assert_allclose(mean.numpy() * n * n, total.numpy(), rtol=1e-5, atol=1e-6)
