"""Parity of the port's reference computation classes, ``EigvalshComputation``
and ``EighComputation``, with the JAX package's, in both model forms: an
``nn.Module`` against the JAX class on the flax module (the structured
engines), and a plain model function ``model_fn(params, X)`` against the
JAX class on the flax ``model_fn`` (the generic engines).  Problems of
``tests/implementation/cases.py``, their weights converted; the JAX side
runs on the CPU.  Also the error paths of the class API and the opt-in
``self_check``.
"""

import jax
import numpy as np
import pytest
import torch

import vivit_tpu as vt

from tests.implementation.cases import PROBLEM_IDS, PROBLEMS
from tests.test_torch_port_ggn import jax_draws, _Replay
from tests.test_torch_port_models import CASES, flax_variables, port_problem
import vivit_tpu_torch as vtt
from vivit_tpu_torch.convert import _leaf_target, leaves_from_flax
from vivit_tpu_torch.engines import forward_fn, module_params
from vivit_tpu_torch.linalg.utils import keep_all, keep_top_k

# BASELINE.md: eigenvalues rtol 1e-4 / atol 5e-6·λmax; eigenvectors rtol
# 2e-2 / atol 2e-3, up to sign
EV_RTOL, EV_ATOL = 1e-4, 5e-6
VEC_RTOL, VEC_ATOL = 2e-2, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(name, form):
    """``(jax model, jax params-or-variables, port model, port params or
    None, port loss, problem, X, y)`` for one model form."""
    problem = PROBLEMS[PROBLEM_IDS.index(name)]
    module, loss, X, y = port_problem(problem)
    if form == "module":
        fmod, variables = flax_variables(*CASES[name])
        return fmod, variables, module, None, loss, problem, X, y
    return problem.model_fn, problem.params, forward_fn(module), module_params(module), \
        loss, problem, X, y


def _groups(problem, model, split):
    """The problem's parameter groups in both naming schemes."""
    layouts = problem.group_layouts()
    jax_groups = layouts["weights_and_biases" if split else "one_group"]
    names = [[_leaf_target(model, *p.split("/"))[0] for p in g] for g in jax_groups]
    return jax_groups, names


def _assert_evals(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = EV_ATOL * max(np.abs(want).max(), 1e-30) + EV_RTOL * np.abs(want)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


EIGVALSH_CASES = {
    "mlp-ce": ("mlp_CrossEntropyLoss_mean", {}),
    "cnn": ("cnn_ce_mean", {}),
    "convtranspose-mse": ("convtranspose_mse_mean", {}),
    "transformer": ("transformer_ce_mean", {}),
    "deflated": ("mlp_CrossEntropyLoss_mean", dict(deflate_ce_null=True)),
    "subsampled-sum": ("mlp_CrossEntropyLoss_sum", dict(subsampling=[2, 0, 5])),
    "dc": ("branched_ce_mean", dict(eig_backend="dc", deflate_ce_null=True)),
}


@pytest.mark.parametrize("form", ["module", "function"])
@pytest.mark.parametrize("case", list(EIGVALSH_CASES))
def test_eigvalsh_computation_matches_jax(case, form):
    name, kw = EIGVALSH_CASES[case]
    jmodel, jparams, model, params, loss, problem, X, y = _setup(name, form)
    split = form == "module"
    jgroups, pgroups = _groups(problem, model if params is None else
                               port_problem(problem)[0], split)
    want = vt.EigvalshComputation(jmodel, problem.loss, **kw).compute(
        jparams, problem.X, problem.y, [{"params": g} for g in jgroups])
    comp = vtt.EigvalshComputation(model, loss, device="cpu", **kw)
    groups = [{"params": g} for g in pgroups]
    got = comp.compute(X, y, groups, params=params)
    assert len(got) == len(want) == len(groups)
    for g, w, group in zip(got, want, groups):
        _assert_evals(g, w)
        assert comp.get_result(group) is g


@pytest.mark.parametrize("form", ["module", "function"])
def test_eigvalsh_computation_mc_matches_jax(form):
    """Monte-Carlo factors, the JAX package's draws replayed into the port."""
    jmodel, jparams, model, params, loss, problem, X, y = _setup("cnn_ce_mean", form)
    want = vt.EigvalshComputation(jmodel, problem.loss, mc_samples=2).compute(
        jparams, problem.X, problem.y, None, key=jax.random.PRNGKey(4))
    loss = _Replay(loss, jax_draws(problem.loss, problem.model_fn, problem.params,
                                   problem.X, problem.y, 2, 4))
    got = vtt.EigvalshComputation(model, loss, mc_samples=2, device="cpu").compute(
        X, y, params=params, key=4)
    _assert_evals(got[0], want[0])


def _assert_vectors(got, want, model, jax_paths):
    """Port eigenvectors (group order, port layout) against the JAX ones
    (group order, flax layout), up to the sign of each direction."""
    want = leaves_from_flax(dict(zip(jax_paths, [np.asarray(w) for w in want])), model)
    G = torch.cat([g.reshape(g.shape[0], -1) for g in got], dim=1).double()
    W = torch.cat([w.reshape(w.shape[0], -1) for w in want.values()], dim=1).double()
    sign = torch.sign((G * W).sum(dim=1, keepdim=True))
    np.testing.assert_allclose((G * sign).numpy(), W.numpy(), rtol=VEC_RTOL, atol=VEC_ATOL)


EIGH_CASES = {
    "mlp-ce": ("mlp_CrossEntropyLoss_mean", {}),
    "kitchensink": ("kitchensink_ce_mean", {}),
    "mse-sum": ("mlp_MSELoss_sum", {}),
    "deflated-dc": ("cnn_ce_mean", dict(deflate_ce_null=True, eig_backend="dc")),
}


@pytest.mark.parametrize("form", ["module", "function"])
@pytest.mark.parametrize("case", list(EIGH_CASES))
def test_eigh_computation_matches_jax(case, form):
    name, kw = EIGH_CASES[case]
    jmodel, jparams, model, params, loss, problem, X, y = _setup(name, form)
    module = port_problem(problem)[0]
    jgroups, pgroups = _groups(problem, module, form == "module")
    criterion = keep_top_k(3)
    want = vt.EighComputation(jmodel, problem.loss, **kw).compute(
        jparams, problem.X, problem.y, [{"params": g, "criterion": criterion}
                                        for g in jgroups])
    comp = vtt.EighComputation(model, loss, device="cpu", **kw)
    groups = [{"params": g, "criterion": criterion} for g in pgroups]
    got = comp.compute(X, y, groups, params=params)
    for (ev, vecs), (ev_j, vecs_j), group, jpaths in zip(got, want, groups, jgroups):
        _assert_evals(ev, ev_j)
        _assert_vectors(vecs, vecs_j, module, jpaths)
        assert comp.get_result(group)[0] is ev
        info = comp.get_eig_info(group)
        assert set(info) == {"tripped", "bound", "orth"} and not bool(info["tripped"])


def test_eigh_computation_keeps_structural_zeros():
    """With Gram-level deflation every eigenvalue reaches the criterion: the
    ``S`` structural zeros come back exactly, the nonzero directions with
    unit parameter-space vectors."""
    _, _, model, params, loss, problem, X, y = _setup("mlp_CrossEntropyLoss_mean", "function")
    comp = vtt.EighComputation(model, loss, deflate_ce_null=True, warn_small_eigvals=0.0,
                               device="cpu")
    (evals, vecs), = comp.compute(X, y, [{"params": list(params), "criterion": keep_all}],
                                  params=params)
    n, c = X.shape[0], 4
    assert evals.shape == (n * c,) and int((evals == 0).sum()) >= n
    norms = torch.cat([v.reshape(v.shape[0], -1) for v in vecs], dim=1).norm(dim=1)
    nonzero = evals > 1e-6 * evals.max()
    torch.testing.assert_close(norms[nonzero], torch.ones_like(norms[nonzero]))


def test_eigh_topk_function_form_matches_module_form():
    """``eigh_topk`` on a model function equals the module form's (the
    generic and the tapped engine), eigenvalues and vectors."""
    problem = PROBLEMS[PROBLEM_IDS.index("kitchensink_ce_mean")]
    module, loss, X, y = port_problem(problem)
    ev_m, vec_m = vtt.eigh_topk(module, loss, X, y, 3, device="cpu")
    ev_f, vec_f = vtt.eigh_topk(forward_fn(module), loss, X, y, 3,
                                params=module_params(module), device="cpu")
    _assert_evals(ev_f, ev_m)
    for a, b in zip(vec_f, vec_m):
        sign = torch.sign((a * b).reshape(a.shape[0], -1).sum(1))
        torch.testing.assert_close(a * sign.reshape(-1, *(1,) * (a.dim() - 1)), b,
                                   rtol=VEC_RTOL, atol=VEC_ATOL)


def test_class_error_paths():
    """The error paths of the class API (as the JAX package raises them)."""
    _, _, model, params, loss, problem, X, y = _setup("mlp_CrossEntropyLoss_mean", "function")
    names = list(params)
    with pytest.raises(ValueError, match="unique"):
        vtt.EigvalshComputation(model, loss, subsampling=[1, 1])
    comp = vtt.EighComputation(model, loss, device="cpu")
    with pytest.raises(KeyError, match="No results"):
        comp.get_result({"params": names})
    with pytest.raises(KeyError, match="No results"):
        comp.get_eig_info({"params": names})
    with pytest.raises(ValueError, match="does not specify 'criterion'"):
        comp.compute(X, y, [{"params": names}], params=params)
    with pytest.raises(ValueError, match="unknown parameter"):
        comp.compute(X, y, [{"params": ["Dense_0/kernel"], "criterion": keep_all}],
                     params=params)
    with pytest.raises(ValueError, match="more than one group"):
        comp.compute(X, y, [{"params": names[:2], "criterion": keep_all},
                            {"params": names[1:], "criterion": keep_all}], params=params)
    eigvalsh = vtt.EigvalshComputation(model, loss, device="cpu")
    with pytest.raises(KeyError, match="No results"):
        eigvalsh.get_result({"params": names})
    with pytest.raises(ValueError, match="needs params="):
        eigvalsh.compute(X, y)
    module = port_problem(problem)[0]
    with pytest.raises(ValueError, match="brings its own parameters"):
        vtt.EigvalshComputation(module, loss, device="cpu").compute(X, y, params=params)
    with pytest.raises(ValueError, match="CrossEntropyLoss only"):
        vtt.EigvalshComputation(model, vtt.MSELoss(), deflate_ce_null=True)
    with pytest.raises(ValueError, match="exact factors"):
        vtt.EighComputation(model, loss, mc_samples=2, deflate_ce_null=True)
    with pytest.raises(ValueError, match="key"):
        vtt.EigvalshComputation(model, loss, mc_samples=2, device="cpu").compute(
            X, y, params=params)


@pytest.mark.parametrize("fixture,message", [("batchnorm", "separability"),
                                             ("kitchensink", "deterministic")])
def test_self_check_catches_train_mode(fixture, message):
    """``self_check`` raises for a train-mode BatchNorm (the batch couples
    the samples) and a train-mode Dropout (two forwards differ), and passes
    once the model is in eval mode."""
    from tests.test_torch_port_models import FIXTURES, port_model

    _, variables = flax_variables(fixture, 0)
    model = port_model(fixture, variables)
    X = torch.tensor(np.random.default_rng(3).normal(
        size=(6, *FIXTURES[fixture][1])).astype(np.float32))
    y = torch.tensor(np.random.default_rng(4).integers(0, 3, size=(6,)))
    model.train()
    comp = vtt.EigvalshComputation(model, vtt.CrossEntropyLoss(), self_check=True,
                                   device="cpu")
    with pytest.raises(RuntimeError, match=message):
        comp.compute(X, y)
    model.eval()
    (evals,) = comp.compute(X, y)
    assert evals.shape == (18,) and bool(torch.isfinite(evals).all())
    fn = vtt.EigvalshComputation(forward_fn(model), vtt.CrossEntropyLoss(), self_check=True,
                                 device="cpu")
    fn.compute(X, y, params=module_params(model))
