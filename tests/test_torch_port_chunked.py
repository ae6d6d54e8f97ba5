"""Parity of the port's streamed memory mode (``vivit_tpu_torch.chunked``)
with the JAX package's ``vivit_tpu.chunked``, mirroring
``tests/test_chunked.py``.

``gram_streamed`` is held against the JAX package's and against the port's
in-memory Gram (``gram_matrix ∘ ggn_sqrt_vt``) on the three problems of the
JAX test, with and without ``subsampling=[2, 0]``, with Monte-Carlo factors
(the JAX draws replayed), with ``deflate_ce_null`` and with ``grad_leaves``;
the pipelines ``eigvalsh_streamed`` (groups, ``eig_backend="dc"``),
``eigh_topk_streamed`` (sign-free vectors), ``newton_step_streamed`` (a
damping callable, ``subsampling_ggn``) and ``backproject_streamed`` against
the JAX package's.  The same weights and numpy batch go through both; the
JAX side is jitted on the CPU.  Bars: Grams and steps rtol 1e-4 / atol
1e-6 (the JAX test's), eigenvalues BASELINE's rtol 1e-4 / atol 5e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivit_tpu import chunked as jax_chunked

from tests.implementation.cases import PROBLEM_IDS, PROBLEMS
from tests.test_torch_port_ggn import replayed
from tests.test_torch_port_models import port_problem
from vivit_tpu_torch import chunked
from vivit_tpu_torch.convert import _leaf_target, leaves_from_flax
from vivit_tpu_torch.engines import forward_fn, module_params
from vivit_tpu_torch.ggn import ggn_sqrt_vt
from vivit_tpu_torch.gram import gram_matrix
from vivit_tpu_torch.precision import full_f32

RTOL, ATOL = 1e-4, 1e-6
EV_RTOL, EV_ATOL = 1e-4, 5e-6
CASES = ["mlp_CrossEntropyLoss_mean", "mlp_MSELoss_sum", "cnn_ce_mean"]


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


@functools.lru_cache(maxsize=None)
def _jax(name, fn_name, *args, **kw):
    """The JAX package's ``chunked.<fn_name>`` on the problem, jitted; an
    int ``key`` becomes a PRNGKey, tuples stay static."""
    p = _problem(name)
    fn = getattr(jax_chunked, fn_name)
    if "key" in kw:
        kw["key"] = jax.random.PRNGKey(kw["key"])
    out = jax.jit(lambda params, X, y: fn(p.model_fn, p.loss, params, X, y, *args, **kw))(
        p.params, p.X, p.y)
    return jax.tree_util.tree_map(np.asarray, out)


def _port(name):
    """``(module, model_fn, params, loss, X, y)`` of a problem in the port."""
    model, loss, X, y = port_problem(_problem(name))
    return model, forward_fn(model), module_params(model), loss, X, y


def _port_paths(model, jax_paths):
    return [_leaf_target(model, *p.split("/"))[0] for p in jax_paths]


def _assert_close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("sub", [None, (2, 0)], ids=["full", "sub"])
@pytest.mark.parametrize("name", CASES)
def test_gram_streamed_matches_jax_and_in_memory(name, sub):
    model, fn, params, loss, X, y = _port(name)
    sub = None if sub is None else list(sub)
    with full_f32():
        got = chunked.gram_streamed(fn, loss, params, X, y, subsampling=sub)
        in_memory = gram_matrix(ggn_sqrt_vt(fn, loss, params, X, y, subsampling=sub))
        from_module = chunked.gram_streamed(model, loss, None, X, y, subsampling=sub)
    _assert_close(got, _jax(name, "gram_streamed",
                            subsampling=None if sub is None else tuple(sub)))
    _assert_close(got, in_memory.numpy())
    assert torch.equal(got, from_module)


def test_gram_streamed_mc_replays_jax_draws():
    name = CASES[0]
    model, fn, params, loss, X, y = _port(name)
    loss = replayed(_problem(name), loss, 3, 3)
    with full_f32():
        got = chunked.gram_streamed(fn, loss, params, X, y, mc_samples=3, key=3)
        in_memory = gram_matrix(ggn_sqrt_vt(fn, loss, params, X, y, mc_samples=3, key=3))
    _assert_close(got, _jax(name, "gram_streamed", mc_samples=3, key=3))
    _assert_close(got, in_memory.numpy())


@pytest.mark.parametrize("name", ["mlp_CrossEntropyLoss_mean", "cnn_ce_mean"])
def test_gram_streamed_deflated_matches_jax(name):
    _, fn, params, loss, X, y = _port(name)
    with full_f32():
        got = chunked.gram_streamed(fn, loss, params, X, y, deflate_ce_null=True)
        in_memory = gram_matrix(ggn_sqrt_vt(fn, loss, params, X, y, deflate_ce_null=True))
    _assert_close(got, _jax(name, "gram_streamed", deflate_ce_null=True))
    _assert_close(got, in_memory.numpy())


def test_gram_streamed_grad_leaves_match_jax():
    """``Vᵀg`` piggybacked on the stream: the same ``[CF·S, N_grad]`` block
    as the JAX package's, the gradients given in each package's layout."""
    name = "cnn_ce_mean"
    problem = _problem(name)
    model, fn, params, loss, X, y = _port(name)
    rng = np.random.default_rng(4)
    flax_leaves = [rng.normal(size=(3, *np.shape(p))).astype(np.float32)
                   for p in jax.tree_util.tree_leaves(problem.params)]
    port_leaves = leaves_from_flax(dict(zip(problem.paths, flax_leaves)), model)
    with full_f32():
        gram, vtg = chunked.gram_streamed(fn, loss, params, X, y, subsampling=[2, 0],
                                          grad_leaves=[port_leaves[k] for k in params])
    p = problem
    want_gram, want_vtg = jax.jit(lambda params_, X_, y_: jax_chunked.gram_streamed(
        p.model_fn, p.loss, params_, X_, y_, subsampling=[2, 0],
        grad_leaves=[jnp.asarray(a) for a in flax_leaves]))(p.params, p.X, p.y)
    _assert_close(gram, np.asarray(want_gram))
    _assert_close(vtg, np.asarray(want_vtg))


def test_gram_streamed_bf16_operands_as_in_memory():
    """``precision=torch.bfloat16``: the in-memory bf16 Gram's arithmetic."""
    _, fn, params, loss, X, y = _port("cnn_ce_mean")
    with full_f32():
        got = chunked.gram_streamed(fn, loss, params, X, y, precision=torch.bfloat16)
        want = gram_matrix(ggn_sqrt_vt(fn, loss, params, X, y), precision=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("deflate", [False, True], ids=["raw", "deflated"])
def test_stream_backward_count(deflate, monkeypatch):
    """The JAX package's loop: CF + CF·(CF+1)/2 slices, (CF−1) + (CF−1)·CF/2
    deflated."""
    _, fn, params, loss, X, y = _port("mlp_CrossEntropyLoss_mean")
    calls = []
    single = chunked._vt_single_factor
    monkeypatch.setattr(chunked, "_vt_single_factor",
                        lambda *a: calls.append(1) or single(*a))
    chunked.gram_streamed(fn, loss, params, X, y, deflate_ce_null=deflate)
    cf = 4 - deflate
    assert len(calls) == cf + cf * (cf + 1) // 2


@pytest.mark.parametrize("form", ["function", "module"])
def test_eigvalsh_streamed_groups_match_jax(form):
    name = CASES[0]
    problem = _problem(name)
    model, fn, params, loss, X, y = _port(name)
    kernels = tuple(p for p in problem.paths if p.endswith("kernel"))
    rest = tuple(p for p in problem.paths if not p.endswith("kernel"))
    want = _jax(name, "eigvalsh_streamed", group_paths=(kernels, rest))
    groups = (_port_paths(model, kernels), _port_paths(model, rest))
    args = (fn, loss, params) if form == "function" else (model, loss, None)
    got = chunked.eigvalsh_streamed(*args, X, y, group_paths=groups, device="cpu")
    assert len(got) == 2
    for g, w in zip(got, want):
        _assert_close(g, w, EV_RTOL, EV_ATOL)


@pytest.mark.parametrize("backend", ["xla", "dc"])
def test_eigvalsh_streamed_backends_match_jax(backend):
    name = "cnn_ce_mean"
    _, fn, params, loss, X, y = _port(name)
    (got,) = chunked.eigvalsh_streamed(fn, loss, params, X, y, eig_backend=backend,
                                       deflate_ce_null=True, device="cpu")
    (want,) = _jax(name, "eigvalsh_streamed", eig_backend=backend, deflate_ce_null=True)
    _assert_close(got, want, EV_RTOL, EV_ATOL)
    assert int((got == 0).sum()) >= X.shape[0]  # the structural zeros, exact


@pytest.mark.parametrize("deflate", [False, True], ids=["raw", "deflated"])
def test_eigh_topk_streamed_matches_jax(deflate):
    name, k = "cnn_ce_mean", 3
    problem = _problem(name)
    model, fn, params, loss, X, y = _port(name)
    ev, vecs = chunked.eigh_topk_streamed(fn, loss, params, X, y, k,
                                          deflate_ce_null=deflate, device="cpu")
    want_ev, want_vecs = _jax(name, "eigh_topk_streamed", k, deflate_ce_null=deflate)
    _assert_close(ev, want_ev, EV_RTOL, EV_ATOL)
    want = leaves_from_flax(dict(zip(problem.paths, want_vecs)), model)
    assert len(vecs) == len(params)
    flat_g = torch.cat([v.reshape(k, -1) for v in vecs], dim=1)
    flat_w = torch.cat([want[n].reshape(k, -1) for n in params], dim=1)
    dots = (flat_g * flat_w).sum(dim=1).abs()
    np.testing.assert_allclose(dots.numpy(), 1.0, atol=1e-3)


def test_eigh_topk_streamed_rejects_k_past_rank():
    _, fn, params, loss, X, y = _port(CASES[0])
    with pytest.raises(ValueError, match="deflated"):
        chunked.eigh_topk_streamed(fn, loss, params, X, y, 3 * X.shape[0] + 1,
                                   deflate_ce_null=True, device="cpu")


@pytest.mark.parametrize("sub_ggn", [None, (0, 2, 3)], ids=["full", "sub_ggn"])
def test_newton_step_streamed_matches_jax(sub_ggn):
    """The step with the damping callable, against the JAX package's."""
    name, k = CASES[0], 3
    problem = _problem(name)
    model, fn, params, loss, X, y = _port(name)

    def damping(evals, evecs, gammas, lambdas):
        return 1.0 + 0.1 * lambdas.mean(dim=0)

    got = chunked.newton_step_streamed(
        fn, loss, params, X, y, k, damping=damping,
        subsampling_ggn=None if sub_ggn is None else list(sub_ggn), device="cpu")
    p = problem
    want = jax.jit(lambda params_, X_, y_: jax_chunked.newton_step_streamed(
        p.model_fn, p.loss, params_, X_, y_, k,
        damping=lambda e, v, g, lam: 1.0 + 0.1 * jnp.mean(lam, axis=0),
        subsampling_ggn=sub_ggn))(p.params, p.X, p.y)
    want = leaves_from_flax({path: np.asarray(w)[None] for path, w in
                             zip(problem.paths, want)}, model)
    assert len(got) == len(params)
    for g, n in zip(got, params):
        _assert_close(g, want[n][0].numpy())


def test_newton_step_streamed_deflated_and_scalar_damping():
    name, k = "cnn_ce_mean", 2
    problem = _problem(name)
    model, fn, params, loss, X, y = _port(name)
    got = chunked.newton_step_streamed(fn, loss, params, X, y, k, damping=0.5,
                                       deflate_ce_null=True, device="cpu")
    want = _jax(name, "newton_step_streamed", k, damping=0.5, deflate_ce_null=True)
    want = leaves_from_flax({path: w[None] for path, w in zip(problem.paths, want)}, model)
    for g, n in zip(got, params):
        _assert_close(g, want[n][0].numpy())
    with pytest.raises(ValueError, match="mean"):
        _, sum_loss, _, _ = port_problem(_problem("mlp_CrossEntropyLoss_sum"))
        chunked.newton_step_streamed(fn, sum_loss, params, X, y, k, device="cpu")


def test_backproject_streamed_matches_jax():
    name = "mlp_MSELoss_sum"
    problem = _problem(name)
    model, fn, params, loss, X, y = _port(name)
    rng = np.random.default_rng(8)
    weights = rng.normal(size=(4 * X.shape[0], 2)).astype(np.float32)
    _, _, paths, Xs, factors = chunked._prepare_factors(
        fn, loss, params, X, y, paths=None, subsampling=None, mc_samples=0, key=None,
        batch_size=None)
    with full_f32():
        got = chunked.backproject_streamed(fn, params, Xs, factors, paths,
                                           torch.tensor(weights))
    p = problem

    def jax_back(params_, X_, y_):
        j_paths, j_Xs, j_factors, _ = jax_chunked._prepare_factors(
            p.model_fn, p.loss, params_, X_, y_, paths=None, subsampling=None,
            mc_samples=0, key=None, batch_size=None)
        return jax_chunked.backproject_streamed(p.model_fn, params_, j_Xs, j_factors,
                                                j_paths, jnp.asarray(weights))

    want = jax.jit(jax_back)(p.params, p.X, p.y)
    want = leaves_from_flax({path: np.asarray(w) for path, w in
                             zip(problem.paths, want)}, model)
    for g, n in zip(got, paths):
        _assert_close(g, want[n].numpy())
