"""Parity of the port's data-parallel directional derivatives and Newton
steps (``vivit_tpu_torch.parallel``: ``directional_derivatives_dp``,
``newton_step_dp``, ``train_step_dp``) with the JAX package's, on the dict
MLP of ``tests/parallel/test_data_parallel.py``.

The port runs once for the file in a gloo group of 4 CPU ranks
(:mod:`tests.torch_dp`); the JAX builders run on a mesh of 4 CPU devices.
γ and λ come back from each rank as its own rows; stacked in rank order
they are the global arrays that JAX returns sharded.  Bars (the JAX
tests'): eigenvalues rtol 1e-4 / atol 5e-6, |γ| and λ rtol 1e-4 / atol
1e-5, steps rtol 1e-4 / atol 1e-6 (the lobpcg step against the eigh step
rtol 1e-3 / atol 1e-5, as ``test_newton_step_dp_solver_knob``).
"""

import numpy as np
import pytest
import torch

import vivit_tpu_torch as vtt
from vivit_tpu_torch import parallel as par

from tests import torch_dp
from tests.torch_dp import K, N, Raised, mlp_fn, result

EV_RTOL, EV_ATOL = 1e-4, 5e-6
GL_RTOL, GL_ATOL = 1e-4, 1e-5
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
CPU = dict(device="cpu")
GROUPS = (("w1", "b1"), ("w2",))
SUB_GRAD, SUB_GGN = [1, 4, 8, 12], [0, 3, 9, 14, 7, 11]
DD_SUB_GRAD, DD_SUB_GGN = [1, 4, 6, 9, 13], [0, 2, 5, 8, 10, 14]


def _ce():
    return vtt.CrossEntropyLoss("mean")


def torch_damping(evals, evecs, gammas, lambdas):
    """Depends on the eigenvalues and sample statistics of γ/λ only (the
    Gram-space vectors' order is layout-specific)."""
    return 0.5 + gammas.abs().mean(dim=0) + 0.1 * lambdas.mean(dim=0)


# ---- the rank side (torch only) ---------------------------------------------


def _newton(r, k, damping=1.0, group=None, full=False, **kw):
    params, X_l, y_l, X, y = r.mlp()
    fn = par.newton_step_dp(mlp_fn, _ce(), group, k, damping, **CPU, **kw)
    return fn(params, X, y) if full else fn(params, X_l, y_l)


def case_dd(r):
    params, X_l, y_l, _, _ = r.mlp()
    return par.directional_derivatives_dp(mlp_fn, _ce(), None, 3, **CPU)(params, X_l, y_l)


def case_dd_sub_groups(r):
    params, X_l, y_l, _, _ = r.mlp()
    return par.directional_derivatives_dp(
        mlp_fn, _ce(), None, 2, subsampling_grad=DD_SUB_GRAD, subsampling_ggn=DD_SUB_GGN,
        group_paths=GROUPS, **CPU)(params, X_l, y_l)


def case_newton(r):
    return _newton(r, 4)


def case_newton_k1(r):
    return _newton(r, 4, group=r.solo, full=True)


def case_newton_sub(r):
    return _newton(r, 3, subsampling_grad=SUB_GRAD, subsampling_ggn=SUB_GGN)


def case_newton_groups(r):
    with_info = _newton(r, 2, group_paths=GROUPS, return_eig_info=True)
    return {"with_info": with_info, "without": _newton(r, 2, group_paths=GROUPS)}


def case_newton_deflated(r):
    return _newton(r, 3, deflate_ce_null=True)


def case_newton_callable(r):
    return _newton(r, 4, damping=torch_damping)


def case_newton_solvers(r):
    return {solver: _newton(r, 3, solver=solver) for solver in ("eigh", "dc", "lobpcg")}


def case_newton_rank_guard(r):
    return _newton(r, 8, subsampling_ggn=[0, 5])  # |S|·C = 6 < 8


def case_train(r):
    """One step against JAX; three steps lower the loss on the batch."""
    params, X_l, y_l, X, y = r.mlp()
    step = par.train_step_dp(mlp_fn, _ce(), None, 2, damping=1.0, lr=0.1, **CPU)
    first, evals = step(params, X_l, y_l)
    losses = [float(_ce()(mlp_fn(params, X), y))]
    p = params
    for _ in range(3):
        p, _ = step(p, X_l, y_l)
        losses.append(float(_ce()(mlp_fn(p, X), y)))
    return {"params": first, "evals": evals, "losses": losses}


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


@pytest.fixture(scope="module")
def port():
    return torch_dp.spawn_cases(CASES, {"mlp": torch_dp.mlp_data()})


# ---- the JAX side (pytest process) ------------------------------------------


def _jax(builder, *args, **kw):
    import vivit_tpu as vt
    from vivit_tpu import parallel as jpar

    from tests.parallel.test_data_parallel import _setup

    model_fn, params, X, y = _setup()
    fn = getattr(jpar, builder)(model_fn, vt.CrossEntropyLoss("mean"), torch_dp.jax_mesh(),
                                *args, **kw)
    return fn(params, X, y, None)


def _stack_rows(port, name, i, group=None):
    """Rank-ordered stack of every rank's rows of output ``i``."""
    parts = [result(port, name, rank)[i] for rank in range(K)]
    if group is not None:
        parts = [p[group] for p in parts]
    return np.concatenate(parts, axis=0)


def _assert_step(got, want, names=None, rtol=STEP_RTOL, atol=STEP_ATOL):
    """A port step (dict, or list in ``names`` order) against the JAX
    package's (dict, or list)."""
    if isinstance(got, dict):
        names = names or list(got)
        got = [got[n] for n in names]
        want = [want[n] for n in names]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


def test_directional_derivatives_dp_matches_jax(port):
    evals, gammas, lambdas = result(port, "dd")
    assert gammas.shape == lambdas.shape == (N // K, 3)  # this rank's rows
    want_ev, want_g, want_l = _jax("directional_derivatives_dp", 3)
    np.testing.assert_allclose(evals, np.asarray(want_ev), rtol=EV_RTOL, atol=EV_ATOL)
    np.testing.assert_allclose(np.abs(_stack_rows(port, "dd", 1)), np.abs(np.asarray(want_g)),
                               rtol=GL_RTOL, atol=GL_ATOL)
    np.testing.assert_allclose(_stack_rows(port, "dd", 2), np.asarray(want_l),
                               rtol=GL_RTOL, atol=GL_ATOL)


def test_directional_derivatives_dp_subsampling_and_groups(port):
    want = _jax("directional_derivatives_dp", 2, subsampling_grad=DD_SUB_GRAD,
                subsampling_ggn=DD_SUB_GGN, group_paths=GROUPS)
    got_ev = result(port, "dd_sub_groups")[0]
    assert len(got_ev) == len(want[0]) == 2
    unsel_g = np.setdiff1d(np.arange(N), DD_SUB_GRAD)
    unsel_h = np.setdiff1d(np.arange(N), DD_SUB_GGN)
    for g in range(2):
        np.testing.assert_allclose(got_ev[g], np.asarray(want[0][g]), rtol=EV_RTOL,
                                   atol=EV_ATOL)
        gammas = _stack_rows(port, "dd_sub_groups", 1, g)
        lambdas = _stack_rows(port, "dd_sub_groups", 2, g)
        assert np.all(gammas[unsel_g] == 0.0) and np.all(lambdas[unsel_h] == 0.0)
        np.testing.assert_allclose(np.abs(gammas), np.abs(np.asarray(want[1][g])),
                                   rtol=GL_RTOL, atol=GL_ATOL)
        np.testing.assert_allclose(lambdas, np.asarray(want[2][g]), rtol=GL_RTOL,
                                   atol=GL_ATOL)


def test_directional_derivatives_dp_rejects_sum_reduction():
    with pytest.raises(ValueError, match="mean"):
        par.directional_derivatives_dp(mlp_fn, vtt.CrossEntropyLoss("sum"), None, 2, **CPU)


def test_newton_step_dp_matches_jax(port):
    evals, step = result(port, "newton")
    want_ev, want = _jax("newton_step_dp", 4, 1.0)
    np.testing.assert_allclose(evals, np.asarray(want_ev), rtol=EV_RTOL, atol=EV_ATOL)
    _assert_step(step, want)
    for rank in range(1, K):  # replicated
        np.testing.assert_array_equal(result(port, "newton", rank)[1]["w1"], step["w1"])


def test_newton_step_dp_world_size_one_equals_four(port):
    _assert_step(result(port, "newton_k1")[1], result(port, "newton")[1])


def test_newton_step_dp_subsampling(port):
    _, want = _jax("newton_step_dp", 3, 1.0, subsampling_grad=SUB_GRAD,
                   subsampling_ggn=SUB_GGN)
    _assert_step(result(port, "newton_sub")[1], want)


def test_newton_step_dp_group_paths_and_eig_info(port):
    got = result(port, "newton_groups")
    evals, steps, infos = got["with_info"]
    assert len(evals) == len(steps) == len(infos) == 2
    assert all(not bool(i["tripped"]) for i in infos)
    _, want = _jax("newton_step_dp", 2, 1.0, group_paths=GROUPS)
    for g in range(2):
        assert len(steps[g]) == len(GROUPS[g])
        _assert_step(steps[g], want[g])
        for a, b in zip(steps[g], got["without"][1][g]):  # the same step without info
            np.testing.assert_array_equal(a, b)


def test_newton_step_dp_deflated_matches_jax(port):
    _, want = _jax("newton_step_dp", 3, 1.0, deflate_ce_null=True)
    _assert_step(result(port, "newton_deflated")[1], want)


def test_newton_step_dp_damping_callable(port):
    """δ from γ/λ gathered in global sample order, as in the JAX package."""
    import jax.numpy as jnp

    def jax_damping(evals, evecs, gammas, lambdas):
        return 0.5 + jnp.mean(jnp.abs(gammas), axis=0) + 0.1 * jnp.mean(lambdas, axis=0)

    _, want = _jax("newton_step_dp", 4, jax_damping)
    _assert_step(result(port, "newton_callable")[1], want)


@pytest.mark.parametrize("solver", ["eigh", "dc", "lobpcg"])
def test_newton_step_dp_solver_knob(port, solver):
    want_ev, want = _jax("newton_step_dp", 3, 1.0)
    evals, step = result(port, "newton_solvers")[solver]
    np.testing.assert_allclose(evals, np.asarray(want_ev), rtol=EV_RTOL, atol=1e-6)
    if solver == "lobpcg":
        _assert_step(step, want, rtol=1e-3, atol=1e-5)
    else:
        _assert_step(step, want)


def test_newton_step_dp_subsampled_rank_guard(port):
    for rank in range(K):
        out = port[rank]["newton_rank_guard"]
        assert isinstance(out, Raised) and "rank" in out.message, out


def test_newton_step_dp_rejects_sum_reduction():
    with pytest.raises(ValueError, match="mean"):
        par.newton_step_dp(mlp_fn, vtt.CrossEntropyLoss("sum"), None, 2, **CPU)


def test_train_step_dp_matches_jax(port):
    got = result(port, "train")
    import vivit_tpu as vt
    from vivit_tpu.parallel import train_step_dp

    from tests.parallel.test_data_parallel import _setup

    model_fn, params, X, y = _setup()
    new, evals = train_step_dp(model_fn, vt.CrossEntropyLoss("mean"), torch_dp.jax_mesh(), 2,
                               damping=1.0, lr=0.1)(params, X, y, None)
    np.testing.assert_allclose(got["evals"], np.asarray(evals), rtol=EV_RTOL, atol=EV_ATOL)
    _assert_step(got["params"], new)
    assert got["losses"][-1] < got["losses"][0]
