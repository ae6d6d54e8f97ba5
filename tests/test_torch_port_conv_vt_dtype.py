"""The ``conv_vt_dtype`` knob (conv-weight ``Vᵀ`` blocks stored demoted), the
mixed-dtype repairs it needs, and the ``eigh_dc`` knobs.

* Mirrors ``tests/test_tapped.py::test_conv_vt_dtype_demotion``: bf16
  blocks, their f32 Gram within 2e-2 of the f32 blocks' Gram.
* The bf16 Gram, and the headline spectrum on it, with the knob are bit-equal
  to those without: the cast comes after the f32 patch product, so the
  operands the bf16 Gram sees are the same.
* ``eigh_topk`` and ``newton_step_structured`` with the knob against the
  JAX package's with its knob (flax ``SmallCNN``, the same weights and
  batch; the JAX side on the CPU) at BASELINE's bars, the Gram in f32 (the
  JAX package's CPU "bf16" Gram does not round the bias blocks, ROADMAP
  §3); every entry and class takes the knob.
* ``precision.dot_t`` and ``ConvVT``'s products on bf16 blocks (f32 results,
  the upcast exact; the bf16-operand route unchanged).
* ``eigh_dc``/``eigvalsh_dc``/``full_eigh``/``refine_eigh`` accept ``key``
  and ``dm_iters``; a keyword the JAX ``eigh_dc`` does not have raises
  ``TypeError`` naming it.
"""

import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vivit_tpu as vt
from vivit_tpu.eigdc import eigh_dc as jax_eigh_dc
from vivit_tpu.structured import newton_step_structured as jax_newton_step

import vivit_tpu_torch as vtt
from tests.test_torch_port_models import flax_variables, port_model
from vivit_tpu_torch.convert import leaves_from_flax
from vivit_tpu_torch.eig import full_eigh
from vivit_tpu_torch.eigdc import eigh_dc, eigvalsh_dc, refine_eigh
from vivit_tpu_torch.engines import build_vt, forward_fn, module_params
from vivit_tpu_torch.precision import dot_t, full_f32
from vivit_tpu_torch.structured import gram_matrix_mixed, structured_ggn_sqrt_vt
from vivit_tpu_torch.tapped import ConvVT

BF16 = torch.bfloat16
# BASELINE.md: eigenvalues rtol 1e-4 / atol 5e-6·λmax; vectors rtol 2e-2 /
# atol 2e-3 up to sign; the Newton step rtol 1e-5 / atol 1e-5·max(max|ref|, 1)
EV_RTOL, EV_ATOL = 1e-4, 5e-6
VEC_RTOL, VEC_ATOL = 2e-2, 2e-3
NEWTON_RTOL, NEWTON_ATOL = 1e-5, 1e-5
N, K = 8, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    """``(flax module, variables, port SmallCNN, X, y)``, the same weights
    and numpy batch."""
    module, variables = flax_variables("smallcnn", 1)
    rng = np.random.default_rng(3)
    X = rng.normal(size=(N, 6, 6, 1)).astype(np.float32)
    y = rng.integers(0, 3, size=(N,)).astype(np.int32)
    return module, variables, port_model("smallcnn", variables), X, y


def _grams(model, X, y, precision=None, **kw):
    loss = vtt.CrossEntropyLoss("mean")
    with full_f32():
        mixed = structured_ggn_sqrt_vt(model, loss, torch.tensor(X), torch.tensor(y), **kw)
        return mixed, gram_matrix_mixed(mixed, generic_precision=precision)


def test_bf16_blocks_within_2e2_of_f32_gram(problem):
    _, _, model, X, y = problem
    _, g_f32 = _grams(model, X, y)
    mixed, g_bf16 = _grams(model, X, y, conv_vt_dtype=BF16)
    conv = [leaf for leaf in mixed.values() if isinstance(leaf, ConvVT)]
    assert conv and all(leaf.vt.dtype == BF16 for leaf in conv)
    assert g_bf16.dtype == torch.float32  # bf16 blocks, f32 Gram (dot_t repaired)
    np.testing.assert_allclose(g_bf16.numpy(), g_f32.numpy(), rtol=2e-2,
                               atol=2e-2 * g_f32.abs().max().item())


def test_bf16_gram_bit_equal_with_the_knob(problem):
    """The bf16 Gram and the headline spectrum on it: knob or not, the same
    bits."""
    _, _, model, X, y = problem
    _, without = _grams(model, X, y, precision=BF16, deflate_ce_null=True)
    _, with_knob = _grams(model, X, y, precision=BF16, deflate_ce_null=True,
                          conv_vt_dtype=BF16)
    assert torch.equal(with_knob, without)
    loss = vtt.CrossEntropyLoss("mean")
    headline = dict(gram_precision="bf16", deflate_ce_null=True, device="cpu")
    for backend in ("xla", "dc"):
        (a,) = vtt.eigvalsh_structured(model, loss, X, y, eig_backend=backend, **headline)
        (b,) = vtt.eigvalsh_structured(model, loss, X, y, eig_backend=backend,
                                       conv_vt_dtype=BF16, **headline)
        assert torch.equal(a, b), backend


def test_eigh_topk_with_the_knob_matches_jax(problem):
    module, variables, model, X, y = problem
    loss = vtt.CrossEntropyLoss("mean")
    evals, vecs = vtt.eigh_topk(model, loss, X, y, K, conv_vt_dtype=BF16, device="cpu")
    want_ev, want_vecs = jax.jit(lambda v, X_, y_: vt.eigh_topk(
        module, vt.CrossEntropyLoss("mean"), v, X_, y_, K, conv_vt_dtype=jnp.bfloat16))(
        variables, jnp.asarray(X), jnp.asarray(y))
    want_ev = np.asarray(want_ev)
    np.testing.assert_allclose(evals.numpy(), want_ev, rtol=EV_RTOL,
                               atol=EV_ATOL * np.abs(want_ev).max())
    paths = vt.utils.tree.leaf_paths(variables["params"])
    want = leaves_from_flax(dict(zip(paths, [np.asarray(v) for v in want_vecs])), model)
    got = torch.cat([v.reshape(K, -1) for v in vecs], dim=1)
    ref = torch.cat([want[n].reshape(K, -1) for n in module_params(model)], dim=1)
    sign = torch.sign((got * ref).sum(dim=1, keepdim=True))
    np.testing.assert_allclose((got * sign).numpy(), ref.numpy(), rtol=VEC_RTOL,
                               atol=VEC_ATOL)


def test_newton_step_structured_with_the_knob_matches_jax(problem):
    module, variables, model, X, y = problem
    loss = vtt.CrossEntropyLoss("mean")
    step = vtt.newton_step_structured(model, loss, X, y, K, damping=1.0,
                                      deflate_ce_null=True, conv_vt_dtype=BF16,
                                      device="cpu")
    want = jax.jit(lambda v, X_, y_: jax_newton_step(
        module, v, vt.CrossEntropyLoss("mean"), X_, y_, K, damping=1.0,
        deflate_ce_null=True, conv_vt_dtype=jnp.bfloat16))(
        variables, jnp.asarray(X), jnp.asarray(y))
    paths = vt.utils.tree.leaf_paths(variables["params"])
    want = leaves_from_flax(dict(zip(paths, [np.asarray(w)[None] for w in want])), model)
    scale = max(max(w.abs().max().item() for w in want.values()), 1.0)
    for s, name in zip(step, module_params(model)):
        np.testing.assert_allclose(s.numpy(), want[name][0].numpy(), rtol=NEWTON_RTOL,
                                   atol=NEWTON_ATOL * scale)


def test_every_entry_and_class_takes_the_knob(problem):
    _, _, model, X, y = problem
    loss = vtt.CrossEntropyLoss("mean")
    kw = dict(conv_vt_dtype=BF16, device="cpu")
    names = list(module_params(model))
    groups = [{"params": names, "criterion": vtt.keep_top_k(2),
               "damping": vtt.constant_damping(1.0)}]
    outs = [
        vtt.eigvalsh(model, loss, X, y, **kw)[0],
        vtt.EigvalshComputation(model, loss, **kw).compute(X, y)[0],
        vtt.EighComputation(model, loss, **kw).compute(X, y, groups)[0][0],
        vtt.newton_step_topk(model, loss, X, y, 2, **kw)[0],
        vtt.DirectionalDerivativesComputation(model, loss, **kw).compute(X, y, groups)[0][0],
        vtt.DirectionalDampedNewtonComputation(model, loss, **kw).compute(X, y, groups)[0][0],
    ]
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    # a model function has no module structure: the knob is ignored
    fn, params = forward_fn(model), module_params(model)
    Xt, yt = torch.tensor(X), torch.tensor(y)
    with full_f32():
        a = build_vt(fn, loss, params, Xt, yt, conv_vt_dtype=BF16)
        b = build_vt(fn, loss, params, Xt, yt)
    assert all(torch.equal(a[k], b[k]) for k in a)
    got = vtt.eigvalsh(fn, loss, X, y, params=params, conv_vt_dtype=BF16, device="cpu")[0]
    assert torch.equal(got, vtt.eigvalsh(fn, loss, X, y, params=params, device="cpu")[0])


def test_dot_t_on_bf16_operands():
    """``operand_dtype=None`` on bf16 tensors: an f32 result, the exact
    upcast's product; the bf16-operand route as before."""
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.normal(size=(5, 7)).astype(np.float32))
    b = torch.tensor(rng.normal(size=(3, 7)).astype(np.float32))
    ab, bb = a.to(BF16), b.to(BF16)
    got = dot_t(ab, bb)
    assert got.dtype == torch.float32
    assert torch.equal(got, ab.float() @ bb.float().T)
    assert torch.equal(dot_t(a, b, BF16), ab.float() @ bb.float().T)
    assert torch.equal(dot_t(ab, bb, BF16), dot_t(a, b, BF16))
    assert torch.equal(dot_t(a, b), a @ b.T)
    assert dot_t(a.double(), b.double()).dtype == torch.float64


def test_dot_t_blocks_long_f32_contractions():
    """Past ``_K_BLOCK`` the f32 route sums blocks of the contraction."""
    from vivit_tpu_torch.precision import _K_BLOCK

    rng = np.random.default_rng(2)
    a = torch.tensor(rng.normal(size=(4, 3 * _K_BLOCK + 5)).astype(np.float32))
    got = dot_t(a, a)
    blocks = sum(a[:, k:k + _K_BLOCK] @ a[:, k:k + _K_BLOCK].T
                 for k in range(0, a.shape[1], _K_BLOCK))
    assert torch.equal(got, blocks)
    want = a.double() @ a.double().T
    assert ((got.double() - want).norm() / want.norm()).item() < 1e-6


def test_conv_vt_products_on_bf16_blocks(problem):
    """``v_mat_prod``/``vt_mat_prod`` of a bf16 block: the f32 upcast's."""
    _, _, model, X, y = problem
    mixed, _ = _grams(model, X, y, conv_vt_dtype=BF16)
    name, block = next((n, leaf) for n, leaf in mixed.items() if isinstance(leaf, ConvVT))
    up = ConvVT(block.vt.float(), block.kernel_shape)
    rng = np.random.default_rng(1)
    gv = torch.tensor(rng.normal(size=(2, block.num_cols)).astype(np.float32))
    mat = torch.tensor(rng.normal(size=(2, *block.kernel_shape)).astype(np.float32))
    out = block.v_mat_prod(gv)
    assert out.dtype == torch.float32 and out.shape == (2, *block.kernel_shape)
    assert torch.equal(out, up.v_mat_prod(gv))
    assert torch.equal(block.vt_mat_prod(mat), up.vt_mat_prod(mat))


def _psd(n, seed):
    """A full-rank PSD matrix (a Marchenko-Pastur spectrum), solved by the
    chain path without tripping the guard."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    return torch.tensor(A @ A.T / n)


def test_eigh_dc_knobs():
    H = _psd(200, 2)
    ref = torch.linalg.eigvalsh(H.double())
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no guard trip: the dc path answers
        default = eigvalsh_dc(H)
        assert torch.equal(eigvalsh_dc(H, key=0), default)  # the default draws
        assert not torch.equal(eigvalsh_dc(H, key=5), default)  # the key reaches them
        for kw in ({"key": 5}, {"dm_iters": (1, 1, 1)}, {"key": 3, "dm_iters": (0, 1, 0)}):
            ev, vecs = eigh_dc(H, **kw)
            assert vecs.shape == (200, 200)
            np.testing.assert_allclose(ev.double().numpy(), ref.numpy(), rtol=EV_RTOL,
                                       atol=EV_ATOL * ref.abs().max().item())
    assert torch.equal(full_eigh(H, backend="dc", eigenvectors=False, key=5)[0],
                       eigvalsh_dc(H, key=5))
    full_eigh(H, key=1)  # the vendor backend takes it and draws nothing
    ev, Q, res = refine_eigh(H, eigh_dc(H)[1], key=0, dm_iters=(1, 1))
    assert float(res) < 1e-4


@pytest.mark.parametrize("knob", ["kpm", "sign_root", "orth", "terms", "generator", "sweeps"])
def test_eigh_dc_unknown_keyword_raises_type_error(knob):
    """A keyword the JAX ``eigh_dc`` does not have raises ``TypeError``
    naming it, also where it names a key of the internal configuration
    (``kpm``, ``sign_root``, ``orth``) or a knob of another function."""
    assert knob not in inspect.signature(jax_eigh_dc).parameters
    H = _psd(200, 2)
    with pytest.raises(TypeError, match=knob):
        eigh_dc(H, **{knob: 1})
    with pytest.raises(TypeError, match=knob):
        eigvalsh_dc(H, **{knob: 1})
