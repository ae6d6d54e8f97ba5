"""Parity of the port's 3c3d GGN eigenvalue pipeline with the JAX package.

Identical inputs, made with numpy from a seed, go through both packages:
the flax-layout weights of ``cnn3c3d_flax_params(seed=0)`` feed the flax
model directly and the port through ``params_from_flax``.  The JAX side runs
on the CPU at ``highest`` precision (``tests/conftest.py``); the port runs
with ``device="cpu"``.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vivit_tpu as vt
from vivit_tpu.ggn import v_factors as jax_v_factors
from vivit_tpu.models import CNN3c3d as FlaxCNN3c3d
from vivit_tpu.structured import DenseFactor as JaxDenseFactor
from vivit_tpu.structured import eigvalsh_structured as jax_eigvalsh_structured
from vivit_tpu.structured import gram_matrix_mixed as jax_gram_matrix_mixed
from vivit_tpu.tapped import ConvVT as JaxConvVT
from vivit_tpu.tapped import tapped_ggn_sqrt_vt as jax_tapped

from vivit_tpu_torch import CNN3c3d, CrossEntropyLoss
from vivit_tpu_torch.convert import params_from_flax
from vivit_tpu_torch.ggn import v_factors
from vivit_tpu_torch.models import cnn3c3d_flax_params
from vivit_tpu_torch.precision import _PRECISIONS, full_f32
from vivit_tpu_torch.structured import (
    DenseFactor,
    eigvalsh_structured,
    gram_matrix_mixed,
)
from vivit_tpu_torch.tapped import ConvVT, tapped_ggn_sqrt_vt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(n,)).astype(np.int32)
    return X, y


@pytest.fixture(scope="module")
def params_np():
    return cnn3c3d_flax_params(seed=0)


@pytest.fixture(scope="module")
def models(params_np):
    flax_vars = {"params": jax.tree_util.tree_map(jnp.asarray, params_np)}
    model = CNN3c3d()
    model.load_state_dict(params_from_flax(params_np))
    return FlaxCNN3c3d(10), flax_vars, model


def _jax_vt(models, X, y, deflate):
    fmod, fvars, _ = models
    fn = jax.jit(lambda v, X, y: jax_tapped(
        fmod, v, vt.CrossEntropyLoss("mean"), X, y, deflate_ce_null=deflate))
    return fn(fvars, jnp.asarray(X), jnp.asarray(y))


def _port_vt(models, X, y, deflate):
    _, _, model = models
    with full_f32():
        return tapped_ggn_sqrt_vt(model, CrossEntropyLoss("mean"),
                                  torch.tensor(X), torch.tensor(y),
                                  deflate_ce_null=deflate)


def test_logits_match_flax(models):
    fmod, fvars, model = models
    X, _ = _batch(4)
    want = np.asarray(fmod.apply(fvars, jnp.asarray(X)))
    with torch.no_grad(), full_f32():
        got = model(torch.tensor(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_params_from_flax_layouts(params_np):
    state = params_from_flax(params_np)
    model = CNN3c3d()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()
    }
    np.testing.assert_array_equal(
        state["conv1.weight"].numpy()[5, 7, 1, 2],
        params_np["Conv_1"]["kernel"][1, 2, 7, 5],
    )
    # dense0 input (c, h, w) = (3, 1, 2) is flax row (h, w, c) = (1, 2, 3)
    np.testing.assert_array_equal(
        state["dense0.weight"].numpy()[11, 3 * 9 + 1 * 3 + 2],
        params_np["Dense_0"]["kernel"][1 * 3 * 128 + 2 * 128 + 3, 11],
    )


@pytest.mark.parametrize("deflate", [False, True], ids=["raw", "deflated"])
def test_v_factors_match(deflate):
    rng = np.random.default_rng(3)
    f = (3.0 * rng.normal(size=(6, 10))).astype(np.float32)
    y = rng.integers(0, 10, size=(6,)).astype(np.int32)
    want = np.asarray(jax_v_factors(vt.CrossEntropyLoss("mean"), jnp.asarray(f),
                                    jnp.asarray(y), batch_size=8,
                                    deflate_ce_null=deflate))
    got = v_factors(CrossEntropyLoss("mean"), torch.tensor(f), torch.tensor(y),
                    batch_size=8, deflate_ce_null=deflate).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("deflate", [False, True], ids=["raw", "deflated"])
def test_gram_f32_matches(models, deflate):
    X, y = _batch(4)
    want = np.asarray(jax_gram_matrix_mixed(_jax_vt(models, X, y, deflate)))
    with full_f32():
        got = gram_matrix_mixed(_port_vt(models, X, y, deflate)).numpy()
    assert got.shape == want.shape == ((9 if deflate else 10) * 4,) * 2
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_gram_bf16_matches_rounded_vt(models):
    """The bf16 Gram is the f32 contraction of a Vᵀ rounded to bf16 (the
    JAX package's CPU "bf16" is full f32, so it is rounded here by hand)."""
    X, y = _batch(4)

    def rounded(leaf):
        if isinstance(leaf, JaxDenseFactor):
            return leaf
        if isinstance(leaf, JaxConvVT):
            return JaxConvVT(leaf.vt.astype(jnp.bfloat16).astype(jnp.float32),
                             leaf.kernel_shape)
        return leaf.astype(jnp.bfloat16).astype(jnp.float32)

    jvt = {k: rounded(v) for k, v in _jax_vt(models, X, y, True).items()}
    want = np.asarray(jax_gram_matrix_mixed(jvt))
    with full_f32():
        got = gram_matrix_mixed(_port_vt(models, X, y, True),
                                generic_precision=_PRECISIONS["bf16"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_factored_products_match(models):
    """``v_mat_prod``/``vt_mat_prod`` of both block types, in each package's
    own parameter layout."""
    X, y = _batch(3)
    jvt, pvt = _jax_vt(models, X, y, True), _port_vt(models, X, y, True)
    rng = np.random.default_rng(5)
    for jname, pname in (("Dense_1/kernel", "dense1.weight"),
                         ("Conv_1/kernel", "conv1.weight")):
        jl, pl = jvt[jname], pvt[pname]
        assert isinstance(pl, (DenseFactor, ConvVT))
        gv = rng.normal(size=(2, pl.num_cols)).astype(np.float32)
        want = np.asarray(jl.v_mat_prod(jnp.asarray(gv)))
        with full_f32():
            got = pl.v_mat_prod(torch.tensor(gv)).numpy()
        # flax [in, out] / [kh, kw, I, O] → torch [out, in] / [O, I, kh, kw]
        perm = (0, 2, 1) if want.ndim == 3 else (0, 4, 3, 1, 2)
        np.testing.assert_allclose(got, want.transpose(perm), rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
        mat = rng.normal(size=want.shape).astype(np.float32)
        want_t = np.asarray(jl.vt_mat_prod(jnp.asarray(mat)))
        with full_f32():
            got_t = pl.vt_mat_prod(torch.tensor(mat.transpose(perm).copy())).numpy()
        np.testing.assert_allclose(got_t, want_t, rtol=1e-5,
                                   atol=1e-6 * np.abs(want_t).max())


def test_eigvalsh_structured_dc_matches_jax(models):
    """End to end at N=24: the deflated 216² Gram reaches the dc solver's
    windowed Jacobi; 24 structural zeros come back exactly."""
    fmod, fvars, model = models
    X, y = _batch(24, seed=1)
    want = np.asarray(jax.jit(lambda v, X, y: jax_eigvalsh_structured(
        fmod, v, vt.CrossEntropyLoss("mean"), X, y, eig_backend="dc",
        deflate_ce_null=True)[0])(fvars, jnp.asarray(X), jnp.asarray(y)))
    (got,), (info,) = eigvalsh_structured(
        model, CrossEntropyLoss("mean"), X, y, eig_backend="dc",
        deflate_ce_null=True, return_eig_info=True, device="cpu")
    got = got.numpy()
    assert got.shape == (240,)
    assert not bool(info["tripped"])
    assert int((got == 0.0).sum()) == 24
    tol = 5e-6 * abs(want[-1]) + 1e-4 * np.abs(want)
    err = np.abs(got - want)
    assert (err <= tol).all(), f"max err/tol {(err / tol).max():.2f}"


def test_eigvalsh_structured_groups_and_subsampling(models):
    """Per-group Grams with sub-sampling, against the JAX package (vendor
    eigensolver)."""
    fmod, fvars, model = models
    X, y = _batch(6, seed=2)
    sub = [0, 2, 5]
    jgroups = (("Conv_0/bias", "Conv_0/kernel"), ("Dense_2/bias", "Dense_2/kernel"))
    pgroups = (("conv0.weight", "conv0.bias"), ("dense2.weight", "dense2.bias"))
    want = jax.jit(lambda v, X, y: jax_eigvalsh_structured(
        fmod, v, vt.CrossEntropyLoss("sum"), X, y, group_paths=jgroups,
        subsampling=sub))(fvars, jnp.asarray(X), jnp.asarray(y))
    got = eigvalsh_structured(
        model, CrossEntropyLoss("sum"), X, y, group_paths=pgroups,
        subsampling=sub, device="cpu")
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=5e-6 * np.abs(w).max())


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_cross_entropy_matches(reduction):
    rng = np.random.default_rng(4)
    f = (2.0 * rng.normal(size=(5, 10))).astype(np.float32)
    y = rng.integers(0, 10, size=(5,)).astype(np.int32)
    jloss, ploss = vt.CrossEntropyLoss(reduction), CrossEntropyLoss(reduction)
    ft, yt = torch.tensor(f), torch.tensor(y)
    np.testing.assert_allclose(ploss.per_sample(ft, yt).numpy(),
                               np.asarray(jloss.per_sample(f, y)), rtol=1e-6)
    np.testing.assert_allclose(float(ploss(ft, yt)), float(jloss(f, y)), rtol=1e-6)
    want = np.asarray(jax.vmap(jloss.sqrt_hessian)(jnp.asarray(f), jnp.asarray(y)))
    np.testing.assert_allclose(ploss.sqrt_hessian(ft, yt).numpy(), want,
                               rtol=1e-6, atol=1e-7)
    assert ploss.rho(8) == jloss.rho(8)


def test_bad_settings_raise(models):
    from vivit_tpu_torch.losses import Loss

    X, y = _batch(2)
    with pytest.raises(ValueError, match="CrossEntropyLoss"):
        eigvalsh_structured(models[2], Loss(), X, y, deflate_ce_null=True,
                            device="cpu")
    with pytest.raises(ValueError, match="precision"):
        eigvalsh_structured(models[2], CrossEntropyLoss(), X, y,
                            precision="bf16", device="cpu")


def _fallback_grams(flax_module, variables, torch_model, X, y):
    """The tapped engines' Grams (CE, mean) of a flax module and its PyTorch
    twin: ``(port leaves, port Gram, JAX Gram)``."""
    want = jax.jit(lambda v, X, y: jax_gram_matrix_mixed(jax_tapped(
        flax_module, v, vt.CrossEntropyLoss("mean"), X, y)))(
        variables, jnp.asarray(X), jnp.asarray(y))
    with full_f32():
        vt_ = tapped_ggn_sqrt_vt(torch_model, CrossEntropyLoss("mean"), torch.tensor(X),
                                 torch.tensor(y))
        return vt_, gram_matrix_mixed(vt_).numpy(), np.asarray(want)


def test_weight_sharing_raises():
    """A layer applied twice (weight sharing) leaves the tapped fast path
    for the generic engine, as in the JAX package: the same Gram as the JAX
    package's tapped engine, which falls back the same way."""
    import flax.linen as fnn

    class SharedNet(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            dense = fnn.Dense(4)
            return dense(fnn.relu(dense(x)))

    rng = np.random.default_rng(6)
    X = rng.normal(size=(3, 4)).astype(np.float32)
    y = rng.integers(0, 4, size=(3,)).astype(np.int32)
    variables = SharedNet().init(jax.random.PRNGKey(0), jnp.asarray(X))
    layer = torch.nn.Linear(4, 4)
    layer.weight.data = torch.tensor(np.asarray(variables["params"]["Dense_0"]["kernel"]).T)
    layer.bias.data = torch.tensor(np.asarray(variables["params"]["Dense_0"]["bias"]))
    model = torch.nn.Sequential(layer, torch.nn.ReLU(), layer)
    vt_, got, want = _fallback_grams(SharedNet(), variables, model, X, y)
    assert all(isinstance(leaf, torch.Tensor) for leaf in vt_.values())
    assert got.shape == want.shape == (12, 12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_unsupported_layer_raises():
    """A layer outside the fast-path table (LayerNorm) goes to the generic
    engine while the Linear before it keeps its factored block: the same
    Gram as the JAX package's tapped engine."""
    import flax.linen as fnn

    class NormNet(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.LayerNorm()(fnn.Dense(5)(x.reshape(x.shape[0], -1)))

    rng = np.random.default_rng(7)
    X = rng.normal(size=(2, 2, 2, 3)).astype(np.float32)
    y = rng.integers(0, 5, size=(2,)).astype(np.int32)
    variables = NormNet().init(jax.random.PRNGKey(1), jnp.asarray(X))
    norm = {k: rng.normal(size=(5,)).astype(np.float32) for k in ("scale", "bias")}
    variables = {"params": {**variables["params"], "LayerNorm_0": norm}}
    model = torch.nn.Sequential(torch.nn.Flatten(), torch.nn.Linear(12, 5),
                                torch.nn.LayerNorm(5, eps=1e-6))
    dense = variables["params"]["Dense_0"]
    model[1].weight.data = torch.tensor(np.asarray(dense["kernel"]).T)
    model[1].bias.data = torch.tensor(np.asarray(dense["bias"]))
    model[2].weight.data, model[2].bias.data = torch.tensor(norm["scale"]), torch.tensor(norm["bias"])
    vt_, got, want = _fallback_grams(NormNet(), variables, model, X, y)
    assert isinstance(vt_["1.weight"], DenseFactor)
    assert isinstance(vt_["2.weight"], torch.Tensor) and vt_["2.weight"].shape == (5, 2, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_duplicate_subsampling_raises(models):
    X, y = _batch(3)
    with pytest.raises(ValueError, match="unique"):
        eigvalsh_structured(models[2], CrossEntropyLoss(), X, y,
                            subsampling=[0, 0], device="cpu")


def test_full_f32_restores_flags():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with full_f32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


def test_no_device_without_cuda_raises(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    X, y = _batch(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eigvalsh_structured(models[2], CrossEntropyLoss(), X, y)


def test_import_leaves_jax_out():
    code = ("import sys, vivit_tpu_torch, vivit_tpu_torch.eigdc, "
            "vivit_tpu_torch.convert, vivit_tpu_torch.linalg.eigh, "
            "vivit_tpu_torch.linalg.eigvalsh, vivit_tpu_torch.engines, "
            "vivit_tpu_torch.models, vivit_tpu_torch.utils.tree, "
            "vivit_tpu_torch.deflate, vivit_tpu_torch.gram\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'flax' or m == 'vivit_tpu' or m.startswith('vivit_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


def test_package_imports_no_jax_source():
    """Neither the port's package, its examples nor ``chip_smoke.py``
    imports ``jax``, ``jaxlib``, ``flax`` or ``vivit_tpu``."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for top in ("vivit_tpu_torch", "examples_torch"):
        for root, _, files in os.walk(os.path.join(REPO, top)):
            paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    found = []
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "vivit_tpu"):
                    found.append((path, name))
    assert not found, found
