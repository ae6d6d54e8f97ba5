"""Parity of the port's matrix-free curvature products with the JAX
package's, on every problem of ``tests/implementation/cases.py``:
``ggn_vector_product``, ``hessian_vector_product`` and ``ggn_mat_prod``
(two stacked vectors, sub-sampled), each in its package's own parameter
layout (the vectors and results of the JAX side converted with
``leaves_from_flax``).  The JAX side runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivit_tpu.ggn import ggn_mat_prod as jax_ggn_mat_prod
from vivit_tpu.ggn import ggn_vector_product as jax_gvp
from vivit_tpu.ggn import hessian_vector_product as jax_hvp
from vivit_tpu.utils.tree import leaf_paths

from tests.implementation.cases import PROBLEM_IDS, PROBLEMS
from tests.test_torch_port_models import CASES, port_problem
from vivit_tpu_torch.convert import leaves_from_flax
from vivit_tpu_torch.engines import forward_fn, module_params
from vivit_tpu_torch.ggn import ggn_mat_prod, ggn_vector_product, hessian_vector_product
from vivit_tpu_torch.precision import full_f32

# f32 products (BASELINE.md): rtol 1e-5, atol 1e-6·max(max|want|, 1)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stack(tree):
    return torch.cat([t.reshape(t.shape[0], -1) for t in tree.values()], dim=1)


@pytest.mark.parametrize("name", PROBLEM_IDS)
def test_matrix_free_products_match_jax(name):
    """``ggn_vector_product``, ``hessian_vector_product`` and
    ``ggn_mat_prod`` (K=2, sub-sampled) in each package's own layout."""
    problem = PROBLEMS[PROBLEM_IDS.index(name)]
    model, loss, X, y = port_problem(problem)
    fixture = CASES[name][0]
    rng = np.random.default_rng(9)
    paths = leaf_paths(problem.params)
    flat = jax.tree_util.tree_leaves(problem.params)
    stacked = [rng.normal(size=(2, *np.shape(p))).astype(np.float32) for p in flat]
    v_jax = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(problem.params),
                                         [jnp.asarray(s) for s in stacked])

    def to_port(tree):
        return leaves_from_flax(dict(zip(paths, [np.asarray(t) for t in
                                                 jax.tree_util.tree_leaves(tree)])), model)

    v_port = to_port(v_jax)
    params, fn = module_params(model), forward_fn(model)
    first = jax.tree_util.tree_map(lambda t: t[0], v_jax)
    with full_f32():
        got = [ggn_vector_product(fn, loss, params, X, y, {k: t[0] for k, t in v_port.items()}),
               hessian_vector_product(fn, loss, params, X, y,
                                      {k: t[0] for k, t in v_port.items()}),
               ggn_mat_prod(fn, loss, params, X, y, v_port, subsampling=[2, 0])]
    want = [jax.jit(jax_gvp, static_argnums=(0, 1))(problem.model_fn, problem.loss,
                                                    problem.params, problem.X, problem.y, first),
            jax.jit(jax_hvp, static_argnums=(0, 1))(problem.model_fn, problem.loss,
                                                    problem.params, problem.X, problem.y, first),
            jax.jit(lambda p, X, y, v: jax_ggn_mat_prod(
                problem.model_fn, problem.loss, p, X, y, v, subsampling=[2, 0]))(
                problem.params, problem.X, problem.y, v_jax)]
    for g, w, stacked_out in zip(got, want, (False, False, True)):
        w = to_port(w if stacked_out else jax.tree_util.tree_map(lambda t: t[None], w))
        g = g if stacked_out else {k: t[None] for k, t in g.items()}
        assert list(g) == list(params), fixture
        gs, ws = _stack(g), _stack({k: w[k] for k in g})
        np.testing.assert_allclose(gs.numpy(), ws.numpy(), rtol=RTOL,
                                   atol=ATOL * max(ws.abs().max().item(), 1.0))
