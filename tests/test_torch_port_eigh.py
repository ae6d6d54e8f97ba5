"""Parity of the port's top-k GGN eigenpairs with the JAX package.

``eigh_topk`` end to end on 3c3d (Gram-level CE deflation, the dc solver in
eigenvector mode or the vendor eigh, back-projection), and the pieces it is
made of: ``topk_eigh``, the Gram-level deflation, ``v_mat_prod_mixed``,
``normalize`` and ``leaves_from_flax``; and ``refine_eigh``.  Identical inputs, made with numpy
from a seed, go through both packages; the JAX side runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vivit_tpu as vt
from vivit_tpu import deflate as jax_deflate
from vivit_tpu.eig import topk_eigh as jax_topk_eigh
from vivit_tpu.eigdc import refine_eigh as jax_refine_eigh
from vivit_tpu.gram import normalize as jax_normalize
from vivit_tpu.models import CNN3c3d as FlaxCNN3c3d
from vivit_tpu.structured import v_mat_prod_mixed as jax_v_mat_prod_mixed
from vivit_tpu.tapped import tapped_ggn_sqrt_vt as jax_tapped
from vivit_tpu.utils.tree import leaf_paths

from vivit_tpu_torch import CNN3c3d, CrossEntropyLoss, eigh_topk, refine_eigh, topk_eigh
from vivit_tpu_torch import deflate
from vivit_tpu_torch.convert import leaves_from_flax, params_from_flax
from vivit_tpu_torch.gram import normalize
from vivit_tpu_torch.linalg.eigh import backproject
from vivit_tpu_torch.models import cnn3c3d_flax_params
from vivit_tpu_torch.precision import full_f32
from vivit_tpu_torch.structured import v_mat_prod_mixed
from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt

RTOL, ATOL = 1e-4, 5e-6
# eigenvector match, sign-invariant (BASELINE.md)
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
def params_np():
    return cnn3c3d_flax_params(seed=0)


@pytest.fixture(scope="module")
def models(params_np):
    flax_vars = {"params": jax.tree_util.tree_map(jnp.asarray, params_np)}
    model = CNN3c3d()
    model.load_state_dict(params_from_flax(params_np))
    return FlaxCNN3c3d(10), flax_vars, model


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(n,)).astype(np.int32)
    return X, y


def _ce_gram(s, c, d, seed):
    """A ``[CS, CS]`` Gram with the CE null structure (flat index
    ``c·S + n``) and its softmax probabilities."""
    rng = np.random.default_rng(seed)
    logits = 2.0 * rng.normal(size=(s, c))
    p = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    factors = np.sqrt(p)[:, :, None] * (np.eye(c)[None] - p[:, None, :])  # [S, C, C]
    J = rng.normal(size=(s, c, d))
    cols = np.einsum("nck,nkd->cnd", factors, J).reshape(c * s, d)
    return (cols @ cols.T).astype(np.float32), p.astype(np.float32)


def _assert_evals(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = ATOL * np.abs(want).max() + RTOL * np.abs(want)
    err = np.abs(got - want)
    assert (err <= tol).all(), f"max err/tol {(err / tol).max():.2f}"


def _assert_vecs(got, want, rtol=VEC_RTOL, atol=VEC_ATOL):
    """Column (last-axis-stacked) or row vectors equal up to sign: ``got``
    and ``want`` are ``[K, ...]``, vector ``k`` at index ``k``."""
    got = np.asarray(got, np.float64).reshape(got.shape[0], -1)
    want = np.asarray(want, np.float64).reshape(want.shape[0], -1)
    sign = np.sign(np.sum(got * want, axis=1, keepdims=True))
    np.testing.assert_allclose(got * sign, want, rtol=rtol, atol=atol)


def test_ce_deflation_pieces_match_jax():
    s, c = 6, 10
    gram, p = _ce_gram(s, c, 40, seed=0)
    w_j = jax_deflate.ce_null_complement(jnp.asarray(p))
    w_t = deflate.ce_null_complement(torch.tensor(p))
    g_d = deflate.deflate_gram(torch.tensor(gram), w_t).numpy()
    want = np.asarray(jax_deflate.deflate_gram(jnp.asarray(gram), w_j))
    np.testing.assert_allclose(g_d, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())

    nulls = deflate.ce_null_vectors(torch.tensor(p)).numpy()
    np.testing.assert_allclose(
        nulls, np.asarray(jax_deflate.ce_null_vectors(jnp.asarray(p))), rtol=1e-6)
    # exact null vectors of the structured Gram, orthonormal
    assert np.abs(gram @ nulls).max() <= 1e-5 * np.abs(gram).max()
    np.testing.assert_allclose(nulls.T @ nulls, np.eye(s), atol=1e-6)

    vecs = np.random.default_rng(1).normal(size=((c - 1) * s, 4)).astype(np.float32)
    lifted = deflate.lift_gram_vecs(torch.tensor(vecs), w_t).numpy()
    np.testing.assert_allclose(
        lifted, np.asarray(jax_deflate.lift_gram_vecs(jnp.asarray(vecs), w_j)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("solver", ["eigh", "dc"])
def test_deflated_topk_eigh_matches_jax_and_full(solver):
    """The deflated Gram's top-k, lifted, is the full Gram's top-k (here
    (C−1)·S = 171 > 160, so ``"dc"`` runs the chain path)."""
    s, c, k = 19, 10, 8
    gram, p = _ce_gram(s, c, 400, seed=2)
    ev, vecs = deflate.deflated_topk_eigh(torch.tensor(gram), torch.tensor(p), k,
                                          solver=solver)
    ev_j, vecs_j = jax_deflate.deflated_topk_eigh(jnp.asarray(gram), jnp.asarray(p), k)
    _assert_evals(ev.numpy(), np.asarray(ev_j))
    _assert_vecs(vecs.numpy().T, np.asarray(vecs_j).T)
    ev64, vecs64 = np.linalg.eigh(gram.astype(np.float64))
    _assert_evals(ev.numpy(), ev64[-k:])
    _assert_vecs(vecs.numpy().T, vecs64[:, -k:].T)
    with pytest.raises(ValueError, match="k <= "):
        deflate.deflated_topk_eigh(torch.tensor(gram), torch.tensor(p), 172)


def _ggn_like_matrix(n, seed):
    rng = np.random.default_rng(seed)
    lam = np.exp(-np.linspace(0, 11, n)) * 250.0 + 1e-7
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((Q * lam) @ Q.T).astype(np.float32)


def test_topk_eigh_solvers_agree_with_jax():
    A = _ggn_like_matrix(200, seed=3)
    ev_j, vecs_j = jax_topk_eigh(jnp.asarray(A), 10)
    ev_e, vecs_e, info_e = topk_eigh(torch.tensor(A), 10, return_info=True)
    ev_d, vecs_d, info_d = topk_eigh(torch.tensor(A), 10, solver="dc",
                                     return_info=True)
    assert vecs_e.shape == vecs_d.shape == (200, 10)
    assert not bool(info_e["tripped"]) and float(info_e["bound"]) == 0.0
    assert not bool(info_d["tripped"])
    for ev, vecs in ((ev_e, vecs_e), (ev_d, vecs_d)):
        _assert_evals(ev.numpy(), np.asarray(ev_j))
        _assert_vecs(vecs.numpy().T, np.asarray(vecs_j).T)
    with pytest.raises(ValueError, match="solver"):
        topk_eigh(torch.tensor(A), 10, solver="qr")


def test_unported_lobpcg_raises(models):
    """The LOBPCG solver, once unported, runs: ``topk_eigh`` within the
    eigenvalue bar of float64, and ``eigh_topk`` end to end at N=4 with CE
    deflation (the deflated 36² Gram, 5·k < 36) against the JAX package's."""
    A = _ggn_like_matrix(200, seed=3)
    ev, vecs = topk_eigh(torch.tensor(A), 6, solver="lobpcg")
    ev64, vecs64 = np.linalg.eigh(A.astype(np.float64))
    _assert_evals(ev.numpy(), ev64[-6:])
    _assert_vecs(vecs.numpy().T, vecs64[:, -6:].T)
    fmod, fvars, model = models
    X, y = _batch(4)
    ev_j, _ = jax.jit(lambda v, X, y: vt.eigh_topk(
        fmod, vt.CrossEntropyLoss("mean"), v, X, y, 5, solver="lobpcg",
        deflate_ce_null=True))(fvars, jnp.asarray(X), jnp.asarray(y))
    ev, vecs = eigh_topk(models[2], CrossEntropyLoss(), X, y, 5, solver="lobpcg",
                         deflate_ce_null=True, device="cpu")
    _assert_evals(ev.numpy(), np.asarray(ev_j))
    assert [v.shape[0] for v in vecs] == [5] * len(vecs)


def test_leaves_from_flax_matches_params_from_flax(params_np):
    state = params_from_flax(params_np)
    stacked = {f"{name}/{leaf}": np.stack([v, 2.0 * v])
               for name, d in params_np.items() for leaf, v in d.items()}
    leaves = leaves_from_flax(stacked)
    assert set(leaves) == set(state)
    for key, value in state.items():
        assert torch.equal(leaves[key][0], value)
        assert torch.equal(leaves[key][1], 2.0 * value)


def test_normalize_matches_jax():
    rng = np.random.default_rng(4)
    leaves = [rng.normal(size=(3, 4, 5)).astype(np.float32),
              rng.normal(size=(3, 7)).astype(np.float32)]
    got = normalize([torch.tensor(x) for x in leaves])
    want = jax_normalize([jnp.asarray(x) for x in leaves])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_backproject_matches_jax(models):
    """``v_mat_prod_mixed`` + ``normalize`` over every block type (factored
    Dense weights, ConvVT, bias tensors), in the port's layout."""
    fmod, fvars, model = models
    X, y = _batch(3)
    jvt = jax.jit(lambda v, X, y: jax_tapped(
        fmod, v, vt.CrossEntropyLoss("mean"), X, y))(fvars, jnp.asarray(X),
                                                    jnp.asarray(y))
    with full_f32():
        pvt = tapped_ggn_sqrt_vt(model, CrossEntropyLoss("mean"), torch.tensor(X),
                                 torch.tensor(y))
    gv = np.random.default_rng(5).normal(size=(30, 2)).astype(np.float32)
    jpaths = sorted(jvt)
    want = leaves_from_flax(dict(zip(jpaths, jax_normalize(
        jax_v_mat_prod_mixed(jvt, jnp.asarray(gv.T), jpaths)))))
    ppaths = [name for name, _ in model.named_parameters()]
    with full_f32():
        got = dict(zip(ppaths, backproject(pvt, torch.tensor(gv), None, ppaths)))
        raw = dict(zip(ppaths, v_mat_prod_mixed(pvt, torch.tensor(gv.T), ppaths)))
    assert set(got) == set(want)
    total = sum(float(v.square().sum()) for v in got.values())
    np.testing.assert_allclose(total, 2.0, rtol=1e-5)
    for key in ppaths:
        w = want[key].numpy()
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())
        assert raw[key].shape == (2, *dict(model.named_parameters())[key].shape)


@pytest.mark.parametrize("solver", ["dc", "eigh"])
def test_eigh_topk_matches_jax(models, solver):
    """End to end at N=24: the deflated 216² Gram (the dc solver's chain
    path in eigenvector mode), top-10 lifted and back-projected."""
    fmod, fvars, model = models
    X, y = _batch(24, seed=1)
    ev_j, vecs_j = jax.jit(lambda v, X, y: vt.eigh_topk(
        fmod, vt.CrossEntropyLoss("mean"), v, X, y, 10, solver=solver,
        deflate_ce_null=True))(fvars, jnp.asarray(X), jnp.asarray(y))
    ev, vecs = eigh_topk(model, CrossEntropyLoss("mean"), X, y, 10,
                         solver=solver, deflate_ce_null=True, device="cpu")
    _assert_evals(ev.numpy(), np.asarray(ev_j))
    paths = [name for name, _ in model.named_parameters()]
    want = leaves_from_flax(dict(zip(leaf_paths(fvars["params"]),
                                     [np.asarray(v) for v in vecs_j])))
    got = torch.cat([v.reshape(10, -1) for v in vecs], dim=1).double()
    ref = torch.cat([want[p].reshape(10, -1) for p in paths], dim=1)
    # unit norm, near-orthonormal, and the JAX package's vectors up to sign
    np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose((got @ got.T).numpy(), np.eye(10), rtol=1e-3,
                               atol=2e-4)
    _assert_vecs(got.numpy(), ref.numpy())


def test_refine_eigh_warm_start():
    """~zero residual from an exact basis; from a small-drift warm start the
    old basis refines to the new spectrum; the JAX package's values."""
    n = 384
    A = _ggn_like_matrix(n, seed=5)
    evals, Q = torch.linalg.eigh(torch.tensor(A))
    ev, Q2, res = refine_eigh(torch.tensor(A), Q)
    assert float(res) < 1e-5 and Q2.shape == (n, n)
    ref = np.sort(evals.numpy())
    err = np.abs(np.sort(ev.numpy()) - ref)
    assert np.max(err[-40:] / np.abs(ref[-40:])) < 1e-4

    rng = np.random.default_rng(9)
    E = rng.normal(size=A.shape).astype(np.float32)
    A2 = (A + 1e-4 * abs(ref[-1]) * (E + E.T) / (2 * np.sqrt(n))).astype(np.float32)
    ref2 = np.linalg.eigvalsh(A2.astype(np.float64))
    ev2, _, res2 = refine_eigh(torch.tensor(A2), Q)
    err2 = np.abs(np.sort(ev2.numpy()) - ref2)
    assert float(res2) < 1e-2
    assert np.max(err2[-40:] / np.abs(ref2[-40:])) < 1e-3

    ev2_j, _, res2_j = jax.jit(jax_refine_eigh)(jnp.asarray(A2), jnp.asarray(Q.numpy()))
    top, top_j = ev2.numpy()[-40:], np.asarray(ev2_j)[-40:]
    np.testing.assert_allclose(top, top_j, rtol=1e-4)
    np.testing.assert_allclose(float(res2), float(res2_j), rtol=0.1)
