"""Parity of the port's streamed × data-parallel composition
(``vivit_tpu_torch.parallel.streamed``: ``gram_streamed_shard``,
``eigvalsh_streamed_dp``) with the JAX package's, on the dict MLP of
``tests/parallel/test_streamed_dp.py``, and the dry run's twin
(``vivit_tpu_torch.parallel.dryrun``).

The port runs once for the file in a gloo group of 4 CPU ranks
(:mod:`tests.torch_dp`); the JAX builders run on a mesh of 4 CPU devices.
Bars (the JAX tests'): Grams ≤ 1e-6 relative Frobenius, eigenvalues rtol
1e-4 / atol 5e-6.
"""

import numpy as np
import pytest
import torch

import vivit_tpu_torch as vtt
from vivit_tpu_torch import parallel as par
from vivit_tpu_torch.parallel import streamed

from tests import torch_dp
from tests.torch_dp import C, K, N, mlp_fn, recorded, result, rel_fro

EV_RTOL, EV_ATOL = 1e-4, 5e-6
GRAM_BAR = 1e-6
CPU = dict(device="cpu")
SUB = [0, 3, 9, 14]
GROUPS = (("w1", "b1"), ("w2",))
PATHS = ["w1", "b1", "w2"]


def _ce(reduction="mean"):
    return vtt.CrossEntropyLoss(reduction)


# ---- the rank side (torch only) ---------------------------------------------


def _spectrum(r, loss=None, group=None, full=False, key=None, **kw):
    params, X_l, y_l, X, y = r.mlp()
    fn = par.eigvalsh_streamed_dp(mlp_fn, loss or _ce(), group, **CPU, **kw)
    return fn(params, X, y, key) if full else fn(params, X_l, y_l, key)


def _counted_slices():
    return recorded(streamed, "_vt_slice_flat")


def case_gram(r):
    """The f32 streamed Gram, its backward passes, and the in-memory
    ``sharded_gram`` of the same shard's ``Vᵀ``."""
    from vivit_tpu_torch.ggn import ggn_sqrt_vt
    from vivit_tpu_torch.parallel import _flatten_vt

    params, X_l, y_l, _, _ = r.mlp()
    out = {}
    for name, deflate in (("raw", False), ("deflated", True)):
        with _counted_slices() as slices:
            gram = par.gram_streamed_shard(mlp_fn, _ce(), params, X_l, y_l, paths=PATHS,
                                           deflate_ce_null=deflate)
        ids = list(range(r.rank * X_l.shape[0], (r.rank + 1) * X_l.shape[0]))
        vt = ggn_sqrt_vt(mlp_fn, _ce(), params, X_l, y_l, column_scale=(1 / N) ** 0.5,
                         sample_ids=ids, deflate_ce_null=deflate)
        out[name] = {"gram": gram, "passes": len(slices),
                     "in_memory": par.sharded_gram(_flatten_vt(vt, PATHS))}
    return out


def case_passes_c10(r):
    """Deflated CE at C=10 (a 10-class MLP, 2 samples per rank): the
    stream's backward passes per rank."""
    from vivit_tpu_torch.engines import forward_fn, module_params
    from vivit_tpu_torch.models import MLP

    torch.manual_seed(0)
    model = MLP(4, (10,))
    rng = np.random.default_rng(1)
    X = torch.tensor(rng.normal(size=(2 * r.k, 4)), dtype=torch.float32)
    y = torch.tensor(rng.integers(0, 10, size=(2 * r.k,)))
    with _counted_slices() as slices:
        evals = par.eigvalsh_streamed_dp(forward_fn(model), _ce(), None, deflate_ce_null=True,
                                         **CPU)(module_params(model), r.shard(X), r.shard(y))
    (want,) = vtt.eigvalsh(model, _ce(), X, y, deflate_ce_null=True, **CPU)
    return {"passes": len(slices), "evals": evals, "single": want}


def case_mean(r):
    return _spectrum(r)


def case_sum(r):
    return _spectrum(r, loss=_ce("sum"))


def case_deflated(r):
    return _spectrum(r, deflate_ce_null=True)


def case_sub(r):
    return _spectrum(r, subsampling=SUB)


def case_mc(r):
    return _spectrum(r, loss=torch_dp.ReplayedCE(r.data["draws"]), mc_samples=3, key=7)


def case_mc_layout(r):
    return {"k4": _spectrum(r, mc_samples=3, key=5),
            "k1": _spectrum(r, group=r.solo, full=True, mc_samples=3, key=5)}


def case_groups_info(r):
    return _spectrum(r, group_paths=GROUPS, return_eig_info=True)


def case_dc(r):
    return _spectrum(r, eig_backend="dc", deflate_ce_null=True)


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


@pytest.fixture(scope="module")
def port():
    import jax

    data = {"mlp": torch_dp.mlp_data()}
    p = data["mlp"]
    data["draws"] = torch_dp.ce_draws(
        lambda prm, x: jax.numpy.tanh(x @ prm["w1"] + prm["b1"]) @ prm["w2"],
        p["params"], p["X"], p["y"], 3, 7)
    return torch_dp.spawn_cases(CASES, data)


# ---- the JAX side (pytest process) ------------------------------------------


def _jax(**kw):
    import vivit_tpu as vt
    from vivit_tpu.parallel import eigvalsh_streamed_dp

    from tests.parallel.test_data_parallel import _setup

    model_fn, params, X, y = _setup()
    loss = vt.CrossEntropyLoss(kw.pop("reduction", "mean"))
    key = kw.pop("key", None)
    return eigvalsh_streamed_dp(model_fn, loss, torch_dp.jax_mesh(), **kw)(params, X, y, key)


def _assert_evals(got, want):
    got, want = np.sort(np.asarray(got)), np.sort(np.asarray(want))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=EV_RTOL, atol=EV_ATOL)


def _cf_rank_to_rank_cf(gram, cf):
    """A Gram in the stream's ``(cf, rank, n)`` order → the materialized
    ``(rank, cf, n)`` order."""
    n = N // K
    perm = np.arange(cf * N).reshape(cf, K, n).transpose(1, 0, 2).reshape(-1)
    return gram[np.ix_(perm, perm)]


@pytest.mark.parametrize("name", ["raw", "deflated"])
def test_gram_streamed_shard_matches_jax(port, name):
    """Entry by entry in the ``(cf, rank, n)`` order, against the JAX
    package's ``gram_streamed_shard``; the in-memory ``sharded_gram``
    after the permutation."""
    import jax
    from jax.sharding import PartitionSpec as P

    import vivit_tpu as vt
    from vivit_tpu.parallel import gram_streamed_shard

    from tests.parallel.test_data_parallel import _setup

    model_fn, params, X, y = _setup()
    deflate = name == "deflated"
    fn = jax.jit(jax.shard_map(
        lambda p, X_l, y_l: gram_streamed_shard(
            model_fn, vt.CrossEntropyLoss("mean"), p, X_l, y_l, paths=("w1", "b1", "w2"),
            deflate_ce_null=deflate),
        mesh=torch_dp.jax_mesh(), in_specs=(P(), P("data"), P("data")), out_specs=P(),
        check_vma=False))
    want = np.asarray(fn(params, X, y))
    got = result(port, "gram")[name]
    cf = C - deflate
    assert got["gram"].shape == want.shape == (cf * N, cf * N)
    assert rel_fro(got["gram"], want) <= GRAM_BAR
    assert rel_fro(_cf_rank_to_rank_cf(got["gram"], cf), got["in_memory"]) <= GRAM_BAR
    # i outer, j ≤ i inner, the i slice reused for j = i
    assert got["passes"] == cf + cf * (cf - 1) // 2


def test_streamed_dp_45_backward_passes_at_c10(port):
    for rank in range(K):
        assert result(port, "passes_c10", rank)["passes"] == 45
    got = result(port, "passes_c10")
    _assert_evals(got["evals"], got["single"])


def test_streamed_dp_matches_jax(port):
    _assert_evals(result(port, "mean"), _jax())


def test_streamed_dp_sum_reduction(port):
    _assert_evals(result(port, "sum"), _jax(reduction="sum"))


def test_streamed_dp_deflate_ce_null(port):
    got = np.sort(result(port, "deflated"))
    assert got.shape == (C * N,) and (got[:N] == 0.0).all()
    _assert_evals(got, _jax(deflate_ce_null=True))


def test_streamed_dp_subsampling_global_indices(port):
    got = np.sort(result(port, "sub"))
    _assert_evals(got, _jax(subsampling=SUB))
    assert np.abs(got[:(N - len(SUB)) * C]).max() < 5e-6


def test_streamed_dp_mc_replays_jax_draws(port):
    import jax

    _assert_evals(result(port, "mc"), _jax(mc_samples=3, key=jax.random.PRNGKey(7)))


def test_streamed_dp_mc_layout_invariance(port):
    got = result(port, "mc_layout")
    _assert_evals(got["k4"], got["k1"])


def test_streamed_dp_group_paths_and_info(port):
    evs, infos = result(port, "groups_info")
    assert len(evs) == len(infos) == len(GROUPS)
    assert all(not bool(i["tripped"]) for i in infos)
    want, want_infos = _jax(group_paths=GROUPS, return_eig_info=True)
    for g, w in zip(evs, want):
        _assert_evals(g, w)


def test_streamed_dp_dc_backend(port):
    """``eig_backend="dc"`` gives the vendor solver's deflated spectrum."""
    got = result(port, "dc")
    _assert_evals(got, result(port, "deflated"))
    assert int((got == 0).sum()) == N


def test_dryrun_multichip_four_ranks(capsys):
    from vivit_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4)
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): OK" in out and "both engines agree" in out
