"""Parity of the port's model fixtures with the JAX package's flax ones: each
fixture's forward, after its flax variables go through
``vivit_tpu_torch.convert.load_flax``, equals the flax forward.

Also the fixture table the other port test files use to build a port model
from a problem of ``tests/implementation/cases.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vivit_tpu as vt
from vivit_tpu import models as fm

import vivit_tpu_torch as vtt
from vivit_tpu_torch import models as pm
from vivit_tpu_torch.convert import load_flax, params_from_flax, state_dict_from_flax
from vivit_tpu_torch.engines import module_params

# forward parity: f32 on both sides (BASELINE.md: logits at rtol 1e-5)
RTOL, ATOL = 1e-5, 1e-6

# fixture → (flax module, input shape, port module)
FIXTURES = {
    "mlp": (lambda: fm.MLP(features=(8, 4)), (6,), lambda: pm.MLP(6, (8, 4))),
    "linear": (lambda: fm.MLP(features=(4,)), (3,), lambda: pm.MLP(3, (4,))),
    "smallcnn": (lambda: fm.SmallCNN(num_classes=3), (6, 6, 1),
                 lambda: pm.SmallCNN(1, 6, 3)),
    "batchnorm": (lambda: fm.BatchNormNet(hidden=8, num_classes=3), (5,),
                  lambda: pm.BatchNormNet(5, 8, 3)),
    "branched": (lambda: fm.BranchedNet(hidden=6, num_classes=3), (5,),
                 lambda: pm.BranchedNet(5, 6, 3)),
    "convtranspose": (lambda: fm.ConvTransposeNet(num_classes=3), (3, 3, 1),
                      lambda: pm.ConvTransposeNet(1, 3, 3)),
    "transformer": (lambda: fm.TinyTransformer(d_model=6, num_classes=3), (4, 5),
                    lambda: pm.TinyTransformer(5, 6, 3)),
    "kitchensink": (lambda: fm.KitchenSinkNet(num_classes=3), (6, 6, 2),
                    lambda: pm.KitchenSinkNet(2, 6, 3)),
}

# problem of tests/implementation/cases.py → (fixture, init seed)
CASES = {
    "mlp_CrossEntropyLoss_mean": ("mlp", 0), "mlp_CrossEntropyLoss_sum": ("mlp", 0),
    "mlp_MSELoss_mean": ("mlp", 0), "mlp_MSELoss_sum": ("mlp", 0),
    "cnn_ce_mean": ("smallcnn", 1), "batchnorm_ce_mean": ("batchnorm", 2),
    "branched_ce_mean": ("branched", 3), "rankdef_linear_ce_mean": ("linear", 7),
    "convtranspose_mse_mean": ("convtranspose", 4),
    "transformer_ce_mean": ("transformer", 6), "kitchensink_ce_mean": ("kitchensink", 5),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flax_variables(fixture, seed):
    """The flax module and its ``init`` variables (as ``init_model`` makes
    them for the problem)."""
    make_flax, shape, _ = FIXTURES[fixture]
    module = make_flax()
    variables = module.init(jax.random.PRNGKey(seed), jnp.ones((1, *shape), jnp.float32))
    return module, variables


def port_model(fixture, variables):
    """The port fixture with the flax ``variables`` loaded, in eval mode."""
    model = FIXTURES[fixture][2]()
    return load_flax(model, jax.tree_util.tree_map(np.asarray, variables)).eval()


def port_problem(problem):
    """``(port module, port loss, X, y)`` of a ``cases.py`` problem, its
    weights the problem's own."""
    fixture, seed = CASES[problem.name]
    _, variables = flax_variables(fixture, seed)
    np.testing.assert_array_equal(  # the problem's params are these variables'
        np.asarray(jax.tree_util.tree_leaves(problem.params)[0]),
        np.asarray(jax.tree_util.tree_leaves(variables["params"])[0]))
    loss = {vt.CrossEntropyLoss: vtt.CrossEntropyLoss,
            vt.MSELoss: vtt.MSELoss}[type(problem.loss)](problem.loss.reduction)
    return (port_model(fixture, variables), loss, torch.tensor(np.asarray(problem.X)),
            torch.tensor(np.asarray(problem.y)))


def _randomized(variables, seed):
    """The variables with every leaf redrawn from numpy (BatchNorm variances
    positive), so that no transfer rule hides behind an init value."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        a = rng.normal(size=np.shape(leaf)).astype(np.float32)
        if path[-1].key == "var":
            a = rng.uniform(0.5, 2.0, size=np.shape(leaf)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(redraw, variables)


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_forward_matches_flax(fixture):
    module, variables = flax_variables(fixture, 0)
    variables = _randomized(variables, 1)
    shape = FIXTURES[fixture][1]
    X = np.random.default_rng(2).normal(size=(3, *shape)).astype(np.float32)
    want = np.asarray(module.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                   jnp.asarray(X)))
    model = port_model(fixture, variables)
    with torch.no_grad():
        got = model(torch.tensor(X)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * max(np.abs(want).max(), 1))


def test_cnn3c3d_converter_matches_params_from_flax():
    """The general converter and the 3c3d one give the same state dict."""
    params = vtt.models.cnn3c3d_flax_params(seed=3, num_classes=10)
    got = state_dict_from_flax(vtt.CNN3c3d(), {"params": params})
    want = params_from_flax(params)
    assert got.keys() == want.keys()
    for name in got:
        assert torch.equal(got[name], want[name]), name


def test_load_flax_rejects_missing_leaves():
    module, variables = flax_variables("batchnorm", 0)
    partial = {"params": variables["params"]}  # no batch_stats
    with pytest.raises(ValueError, match="running_mean"):
        load_flax(pm.BatchNormNet(5, 8, 3), jax.tree_util.tree_map(np.asarray, partial))


def test_module_params_in_named_parameters_order():
    model = pm.TinyTransformer(5, 6, 3)
    assert list(module_params(model)) == [n for n, _ in model.named_parameters()]
