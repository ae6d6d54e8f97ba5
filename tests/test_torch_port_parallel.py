"""Parity of the port's data-parallel Gram and eigen builders
(``vivit_tpu_torch.parallel``: ``sharded_gram``, ``eigvalsh_dp``,
``eigh_dp``) with the JAX package's, on the dict MLP of
``tests/parallel/test_data_parallel.py`` (N=16, D_IN=5, H=6, C=3), and
the conventions of the port (groups, devices, shards, absent knobs).

The port runs once for the file in a gloo group of 4 CPU ranks (the
``port`` fixture, :mod:`tests.torch_dp`); the JAX builders run on a mesh
of 4 CPU devices.  Bars (the JAX tests'): Grams ≤ 1e-6 relative Frobenius,
eigenvalues rtol 1e-4 / atol 5e-6, eigenvector directions |⟨a, b⟩| within
1e-3 of 1.
"""

import warnings

import numpy as np
import pytest
import torch

import vivit_tpu_torch as vtt
from vivit_tpu_torch import parallel as par

from tests import torch_dp
from tests.torch_dp import C, K, N, Raised, mlp_fn, recorded, result, rel_fro

EV_RTOL, EV_ATOL = 1e-4, 5e-6
GRAM_BAR = 1e-6
CPU = dict(device="cpu")
SUB = [0, 3, 9, 14]  # spans several shards
GROUPS = [["w1", "b1"], ["w2"]]
V_COLS, V_D = 6, 10  # D not a multiple of K: the padded reshard

# ---- the rank side (torch only) ---------------------------------------------


def _ce(reduction="mean"):
    return vtt.CrossEntropyLoss(reduction)


def _v_all():
    return np.random.default_rng(5).normal(size=(K * V_COLS, V_D)).astype(np.float32)


def case_sharded_gram(r):
    v = torch.tensor(_v_all())
    v_l = r.shard(_v_all())
    return {"f32": par.sharded_gram(v_l, None), "solo": par.sharded_gram(v, r.solo),
            "bf16": par.sharded_gram(v_l, None, precision=torch.bfloat16)}


def _eigvalsh_with_gram(r, **kw):
    params, X_l, y_l, _, _ = r.mlp()
    with recorded(par, "sharded_gram") as grams:
        evals = par.eigvalsh_dp(mlp_fn, _ce(), None, **CPU, **kw)(params, X_l, y_l)
    return {"evals": evals, "gram": grams[0]}


def case_plain(r):
    return _eigvalsh_with_gram(r)


def case_deflated(r):
    return _eigvalsh_with_gram(r, deflate_ce_null=True)


def case_sum(r):
    params, X_l, y_l, _, _ = r.mlp()
    return par.eigvalsh_dp(mlp_fn, _ce("sum"), None, **CPU)(params, X_l, y_l)


def case_groups(r):
    params, X_l, y_l, _, _ = r.mlp()
    return par.eigvalsh_dp(mlp_fn, _ce(), None, group_paths=GROUPS, **CPU)(params, X_l, y_l)


def case_sub(r):
    params, X_l, y_l, _, _ = r.mlp()
    return par.eigvalsh_dp(mlp_fn, _ce(), None, subsampling=SUB, **CPU)(params, X_l, y_l)


def case_info(r):
    params, X_l, y_l, _, _ = r.mlp()
    return par.eigvalsh_dp(mlp_fn, _ce(), None, eig_backend="dc", return_eig_info=True,
                           **CPU)(params, X_l, y_l)


def case_mc(r):
    params, X_l, y_l, _, _ = r.mlp()
    loss = torch_dp.ReplayedCE(r.data["draws"])
    return par.eigvalsh_dp(mlp_fn, loss, None, mc_samples=2, **CPU)(params, X_l, y_l, 7)


def case_layouts(r):
    """k = 4 against k = 1 (each rank alone in its group, the whole batch):
    the exact spectrum and the Monte-Carlo one with the port's own draws."""
    params, X_l, y_l, X, y = r.mlp()
    out = {}
    for name, kw, key in (("exact", {}, None), ("mc", dict(mc_samples=2), 3)):
        out[name + "_k4"] = par.eigvalsh_dp(mlp_fn, _ce(), None, **kw, **CPU)(
            params, X_l, y_l, key)
        out[name + "_k1"] = par.eigvalsh_dp(mlp_fn, _ce(), r.solo, **kw, **CPU)(
            params, X, y, key)
    return out


def case_unequal(r):
    params, _, _, X, y = r.mlp()
    n = 5 if r.rank == 0 else 4
    return par.eigvalsh_dp(mlp_fn, _ce(), None, **CPU)(params, X[:n], y[:n])


def case_no_device(r):
    return par.eigvalsh_dp(mlp_fn, _ce(), None)


def case_backend_mismatch(r):
    """A CPU rank on what the group reports as an NCCL group."""
    saved = par.dist.get_backend
    par.dist.get_backend = lambda group=None: "nccl"
    try:
        return par.eigvalsh_dp(mlp_fn, _ce(), None, **CPU)
    finally:
        par.dist.get_backend = saved


def case_eigh_topk(r):
    params, X_l, y_l, _, _ = r.mlp()
    evals, evecs = par.eigh_dp(mlp_fn, _ce(), None, 3, **CPU)(params, X_l, y_l)
    return {"evals": evals, "evecs": evecs}


def case_eigh_criterion(r):
    """The criterion path: one V-transform per call."""
    params, X_l, y_l, _, _ = r.mlp()
    fn = par.eigh_dp(mlp_fn, _ce(), None, criterion=vtt.keep_top_k(3, must_exceed=1e-5),
                     **CPU)
    with recorded(par, "ggn_sqrt_vt") as calls:
        evals, evecs = fn(params, X_l, y_l)
    dc = par.eigh_dp(mlp_fn, _ce(), None, criterion=vtt.keep_top_k(3, must_exceed=1e-5),
                     solver="dc", **CPU)(params, X_l, y_l)[0]
    return {"evals": evals, "evecs": evecs, "vt_calls": len(calls), "dc": dc}


def case_eigh_warn(r):
    params, X_l, y_l, _, _ = r.mlp()
    fn = par.eigh_dp(mlp_fn, _ce(), None, criterion=lambda ev: [0, 1],
                     warn_small_eigvals=1e-4, **CPU)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn(params, X_l, y_l)
    return any("small" in str(w.message).lower() for w in caught)


def case_eigh_empty(r):
    params, X_l, y_l, _, _ = r.mlp()
    evals, evecs = par.eigh_dp(mlp_fn, _ce(), None, criterion=lambda ev: [],
                               warn_small_eigvals=None, **CPU)(params, X_l, y_l)
    return {"evals": evals, "shapes": {n: tuple(v.shape) for n, v in evecs.items()}}


def case_eigh_deflated(r):
    params, X_l, y_l, _, _ = r.mlp()
    evals, evecs = par.eigh_dp(mlp_fn, _ce(), None, 3, deflate_ce_null=True, **CPU)(
        params, X_l, y_l)
    crit = par.eigh_dp(mlp_fn, _ce(), None, criterion=vtt.keep_top_k(3, must_exceed=1e-5),
                       deflate_ce_null=True, **CPU)(params, X_l, y_l)[0]
    return {"evals": evals, "evecs": evecs, "criterion": crit}


def case_eigh_info(r):
    params, X_l, y_l, _, _ = r.mlp()
    ev, _, info = par.eigh_dp(mlp_fn, _ce(), None, 2, solver="dc", return_eig_info=True,
                              **CPU)(params, X_l, y_l)
    ev_c, _, info_c = par.eigh_dp(mlp_fn, _ce(), None, criterion=lambda e: [len(e) - 1],
                                  return_eig_info=True, **CPU)(params, X_l, y_l)
    return {"evals": ev, "info": info, "evals_c": ev_c, "info_c": info_c}


def case_eigh_rank_guard(r):
    params, X_l, y_l, _, _ = r.mlp()
    return par.eigh_dp(mlp_fn, _ce(), None, C * N + 1, **CPU)(params, X_l, y_l)


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


@pytest.fixture(scope="module")
def port():
    import jax

    data = {"mlp": torch_dp.mlp_data()}
    p = data["mlp"]
    data["draws"] = torch_dp.ce_draws(
        lambda prm, x: jax.numpy.tanh(x @ prm["w1"] + prm["b1"]) @ prm["w2"],
        p["params"], p["X"], p["y"], 2, 7)
    return torch_dp.spawn_cases(CASES, data)


# ---- the JAX side (pytest process) ------------------------------------------


def _jax_mlp():
    from tests.parallel.test_data_parallel import _setup

    return _setup()


def _jax_eigvalsh(**kw):
    import vivit_tpu as vt
    from vivit_tpu.parallel import eigvalsh_dp

    model_fn, params, X, y = _jax_mlp()
    loss = vt.CrossEntropyLoss(kw.pop("reduction", "mean"))
    key = kw.pop("key", None)
    return eigvalsh_dp(model_fn, loss, torch_dp.jax_mesh(), **kw)(params, X, y, key)


def _jax_dp_gram(deflate_ce_null):
    """The Gram ``eigvalsh_dp`` solves, from the JAX package's own pieces."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import vivit_tpu as vt
    from vivit_tpu import parallel as jpar
    from vivit_tpu.ggn import ggn_sqrt_vt

    model_fn, params, X, y = _jax_mlp()
    loss = vt.CrossEntropyLoss("mean")

    def per_shard(params, X_l, y_l):
        n_local = X_l.shape[0]
        ids = jax.lax.axis_index("data") * n_local + jnp.arange(n_local)
        scale, _ = jpar._dp_column_scale(loss, n_local * K, None, ids)
        v = ggn_sqrt_vt(model_fn, loss, params, X_l, y_l, column_scale=scale,
                        sample_ids=ids, deflate_ce_null=deflate_ce_null)
        return jpar.sharded_gram(jpar._flatten_vt(v), "data")

    fn = jax.jit(jax.shard_map(per_shard, mesh=torch_dp.jax_mesh(),
                               in_specs=(P(), P("data"), P("data")), out_specs=P(),
                               check_vma=False))
    return np.asarray(fn(params, X, y))


def _assert_evals(got, want):
    got, want = np.sort(np.asarray(got)), np.sort(np.asarray(want))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=EV_RTOL, atol=EV_ATOL)


def _assert_directions(got, want, names_want):
    """``{name: [k, *shape]}`` directions of the port against the JAX
    package's dict, each pair up to sign."""
    k = next(iter(got.values())).shape[0]
    a = np.concatenate([got[n].reshape(k, -1) for n in names_want], axis=1)
    b = np.concatenate([np.asarray(want[n]).reshape(k, -1) for n in names_want], axis=1)
    dots = np.abs(np.sum(a * b, axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-3)


# ---- sharded_gram -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sharded_gram_matches_jax(port, dtype):
    """Entry by entry, in the ``(rank, local_col)`` order; bf16 operands
    against the JAX Gram of the bf16-rounded rows (the JAX CPU Gram does
    not round its operands)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from vivit_tpu.parallel import sharded_gram

    v = _v_all()
    if dtype == "bf16":
        v = torch.tensor(v).bfloat16().float().numpy()
    fn = jax.jit(jax.shard_map(lambda v_l: sharded_gram(v_l, "data"),
                               mesh=torch_dp.jax_mesh(), in_specs=P("data"), out_specs=P(),
                               check_vma=False))
    want = np.asarray(fn(jnp.asarray(v)))
    for rank in range(K):  # replicated
        got = result(port, "sharded_gram", rank)[dtype]
        assert got.shape == (K * V_COLS, K * V_COLS)
        assert rel_fro(got, want) <= GRAM_BAR


def test_sharded_gram_world_size_one_equals_four(port):
    g = result(port, "sharded_gram")
    assert rel_fro(g["f32"], g["solo"]) <= GRAM_BAR


# ---- eigvalsh_dp ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["plain", "deflated"])
def test_eigvalsh_dp_gram_matches_jax(port, name):
    """The Gram the builder solves, entry by entry (``(rank, cf, n)``)."""
    got = result(port, name)["gram"]
    want = _jax_dp_gram(deflate_ce_null=name == "deflated")
    assert got.shape == want.shape == ((C - (name == "deflated")) * N,) * 2
    assert rel_fro(got, want) <= GRAM_BAR


def test_eigvalsh_dp_matches_jax(port):
    _assert_evals(result(port, "plain")["evals"], _jax_eigvalsh())


def test_eigvalsh_dp_sum_reduction(port):
    _assert_evals(result(port, "sum"), _jax_eigvalsh(reduction="sum"))


def test_eigvalsh_dp_deflated_matches_jax(port):
    got = result(port, "deflated")["evals"]
    _assert_evals(got, _jax_eigvalsh(deflate_ce_null=True))
    assert int((got == 0).sum()) == N  # the structural zeros, exact


def test_eigvalsh_dp_deflated_rejects_mse():
    with pytest.raises(ValueError, match="CrossEntropyLoss"):
        par.eigvalsh_dp(mlp_fn, vtt.MSELoss("mean"), None, deflate_ce_null=True, **CPU)


def test_eigvalsh_dp_group_paths(port):
    got = result(port, "groups")
    want = _jax_eigvalsh(group_paths=GROUPS)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_evals(g, w)


def test_eigvalsh_dp_subsampling(port):
    """Global indices: the masked columns give (N − |S|)·C exact zeros."""
    got = np.sort(result(port, "sub"))
    _assert_evals(got, _jax_eigvalsh(subsampling=SUB))
    assert np.allclose(got[:(N - len(SUB)) * C], 0.0, atol=1e-6)


def test_eigvalsh_dp_return_eig_info(port):
    evals, info = result(port, "info")
    assert set(info) == {"tripped", "bound", "orth"}
    assert not bool(info["tripped"])
    want, want_info = _jax_eigvalsh(eig_backend="dc", return_eig_info=True)
    assert not bool(want_info["tripped"])
    _assert_evals(evals, want)


def test_eigvalsh_dp_mc_replays_jax_draws(port):
    import jax

    _assert_evals(result(port, "mc"), _jax_eigvalsh(mc_samples=2, key=jax.random.PRNGKey(7)))


@pytest.mark.parametrize("kind", ["exact", "mc"])
def test_eigvalsh_dp_layout_invariance(port, kind):
    """k = 4 and k = 1 give the same spectrum; Monte-Carlo draws follow the
    global sample id, not the rank."""
    got = result(port, "layouts")
    _assert_evals(got[kind + "_k4"], got[kind + "_k1"])


# ---- conventions ----------------------------------------------------------------


def test_unequal_shards_raise(port):
    for rank in range(K):
        out = port[rank]["unequal"]
        assert isinstance(out, Raised) and out.type == "ValueError", out
        assert "unequal shards" in out.message and "[5, 4, 4, 4]" in out.message


def test_builder_without_card_or_cpu_raises(port):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    out = port[0]["no_device"]
    assert isinstance(out, Raised) and out.type == "RuntimeError", out
    assert "device='cpu'" in out.message


def test_backend_and_device_must_match(port):
    out = port[0]["backend_mismatch"]
    assert isinstance(out, Raised) and out.type == "ValueError", out
    assert "gloo" in out.message


def test_uninitialized_group_raises():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        par.eigvalsh_dp(mlp_fn, vtt.CrossEntropyLoss(), None, **CPU)
    with pytest.raises(RuntimeError, match="init_process_group"):
        par.sharded_gram(torch.zeros(2, 3))


BUILDERS = {
    "sharded_gram": lambda **kw: par.sharded_gram(torch.zeros(2, 3), **kw),
    "eigvalsh_dp": lambda **kw: par.eigvalsh_dp(mlp_fn, vtt.CrossEntropyLoss(), None, **kw),
    "eigvalsh_dp_structured": lambda **kw: par.eigvalsh_dp_structured(
        torch_dp.ConvNet(), vtt.CrossEntropyLoss(), None, **kw),
    "eigh_dp": lambda **kw: par.eigh_dp(mlp_fn, vtt.CrossEntropyLoss(), None, 2, **kw),
    "directional_derivatives_dp": lambda **kw: par.directional_derivatives_dp(
        mlp_fn, vtt.CrossEntropyLoss(), None, 2, **kw),
    "newton_step_dp": lambda **kw: par.newton_step_dp(
        mlp_fn, vtt.CrossEntropyLoss(), None, 2, **kw),
    "newton_step_dp_structured": lambda **kw: par.newton_step_dp_structured(
        torch_dp.ConvNet(), vtt.CrossEntropyLoss(), None, 2, **kw),
    "train_step_dp": lambda **kw: par.train_step_dp(
        mlp_fn, vtt.CrossEntropyLoss(), None, 2, **kw),
    "gram_streamed_shard": lambda **kw: par.gram_streamed_shard(
        mlp_fn, vtt.CrossEntropyLoss(), {}, torch.zeros(2, 5), torch.zeros(2),
        paths=[], **kw),
    "eigvalsh_streamed_dp": lambda **kw: par.eigvalsh_streamed_dp(
        mlp_fn, vtt.CrossEntropyLoss(), None, **kw),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_axis_name_raises_type_error(name):
    """There is no ``axis_name``: the group takes the mesh's place."""
    with pytest.raises(TypeError, match="axis_name"):
        BUILDERS[name](axis_name="data")


def test_exports_match_the_jax_package():
    import vivit_tpu.parallel as jpar

    names = {"sharded_gram", "eigvalsh_dp", "eigvalsh_dp_structured", "eigh_dp",
             "directional_derivatives_dp", "newton_step_dp", "newton_step_dp_structured",
             "train_step_dp", "gram_streamed_shard", "eigvalsh_streamed_dp"}
    assert set(par.__all__) == names
    for name in names:
        assert callable(getattr(jpar, name)) and callable(getattr(par, name))


# ---- eigh_dp ----------------------------------------------------------------------


def _jax_eigh(k, **kw):
    import vivit_tpu as vt
    from vivit_tpu.parallel import eigh_dp

    model_fn, params, X, y = _jax_mlp()
    return eigh_dp(model_fn, vt.CrossEntropyLoss("mean"), torch_dp.jax_mesh(), k_top=k,
                   **kw)(params, X, y, None)


def test_eigh_dp_matches_jax(port):
    got = result(port, "eigh_topk")
    want_ev, want_vecs = _jax_eigh(3)
    np.testing.assert_allclose(got["evals"], np.asarray(want_ev), rtol=EV_RTOL, atol=1e-6)
    _assert_directions(got["evecs"], want_vecs, ["w1", "b1", "w2"])
    for rank in range(1, K):  # replicated
        np.testing.assert_array_equal(result(port, "eigh_topk", rank)["evecs"]["w1"],
                                      got["evecs"]["w1"])


def test_eigh_dp_criterion_single_vt_pass(port):
    """The host criterion keeps the k_top result, from one V-transform; the
    dc solver gives the same eigenvalues."""
    got = result(port, "eigh_criterion")
    assert got["vt_calls"] == 1
    top = result(port, "eigh_topk")
    np.testing.assert_allclose(got["evals"], top["evals"], rtol=EV_RTOL, atol=1e-6)
    _assert_directions(got["evecs"], top["evecs"], ["w1", "b1", "w2"])
    np.testing.assert_allclose(got["dc"], got["evals"], rtol=1e-5, atol=1e-7)


def test_eigh_dp_small_eigenvalue_warning(port):
    assert result(port, "eigh_warn") is True


def test_eigh_dp_empty_criterion_selection(port):
    got = result(port, "eigh_empty")
    assert got["evals"].shape == (0,)
    assert got["shapes"] == {"w1": (0, 5, 6), "b1": (0, 6), "w2": (0, 6, 3)}


def test_eigh_dp_lobpcg_criterion_rejected():
    with pytest.raises(ValueError, match="full spectrum"):
        par.eigh_dp(mlp_fn, vtt.CrossEntropyLoss(), None,
                    criterion=vtt.keep_top_k(2), solver="lobpcg", **CPU)


def test_eigh_dp_deflated_matches_jax(port):
    got = result(port, "eigh_deflated")
    want_ev, want_vecs = _jax_eigh(3, deflate_ce_null=True)
    np.testing.assert_allclose(got["evals"], np.asarray(want_ev), rtol=EV_RTOL, atol=1e-6)
    _assert_directions(got["evecs"], want_vecs, ["w1", "b1", "w2"])
    # the criterion sees the deflated (C−1)·N spectrum; same top-3
    np.testing.assert_allclose(got["criterion"], got["evals"], rtol=EV_RTOL, atol=1e-6)


def test_eigh_dp_return_eig_info(port):
    got = result(port, "eigh_info")
    assert not bool(got["info"]["tripped"]) and not bool(got["info_c"]["tripped"])
    assert got["evals_c"].shape == (1,)
    np.testing.assert_allclose(got["evals"][-1], got["evals_c"][0], rtol=EV_RTOL)


def test_eigh_dp_rank_guard(port):
    out = port[0]["eigh_rank_guard"]
    assert isinstance(out, Raised) and "exceeds the Gram rank" in out.message, out
