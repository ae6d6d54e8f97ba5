"""Parity of the port's Gram algebra (``gram.py``), engine dispatch
(``engines.py``) and parameter-tree helpers (``utils/tree.py``) with the
JAX package's, on random numpy inputs.

The port's trees are flat dicts in insertion order where the JAX package
sorts dict keys; the trees here are built with sorted names so that both
orders agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivit_tpu import gram as jgram
from vivit_tpu.utils import tree as jtree

from vivit_tpu_torch import gram as pgram
from vivit_tpu_torch import engines
from vivit_tpu_torch.utils import tree as ptree

# f32 contractions (BASELINE.md): rtol 1e-5, atol 1e-6·max
RTOL, ATOL = 1e-5, 1e-6
CF, S = 3, 4
SHAPES = {"a_bias": (5,), "b_kernel": (2, 3), "c_conv": (2, 2, 3)}


def _vt(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(CF, S, *shape)).astype(np.float32) for k, shape in SHAPES.items()}


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("paths", [None, ["c_conv", "a_bias"]], ids=["all", "group"])
def test_gram_and_projections_match_jax(paths):
    vt_np = _vt()
    jvt = {k: jnp.asarray(v) for k, v in vt_np.items()}
    pvt = {k: torch.tensor(v) for k, v in vt_np.items()}
    _close(pgram.gram_matrix(pvt, paths), jgram.gram_matrix(jvt, paths))
    # the bf16 operand dtype: the f32 Gram of the operands rounded to bf16
    rounded = {k: v.to(torch.bfloat16).float() for k, v in pvt.items()}
    _close(pgram.gram_matrix(pvt, paths, precision=torch.bfloat16),
           pgram.gram_matrix(rounded, paths))
    rng = np.random.default_rng(1)
    gv = rng.normal(size=(2, CF * S)).astype(np.float32)
    got_paths, got = pgram.v_mat_prod(pvt, torch.tensor(gv), paths)
    want_paths, want = jgram.v_mat_prod(jvt, jnp.asarray(gv), paths)
    assert got_paths == list(want_paths)
    for g, w in zip(got, want):
        _close(g, w)
    names = paths or list(SHAPES)
    mats = [rng.normal(size=(2, *SHAPES[k])).astype(np.float32) for k in names]
    _close(pgram.vt_mat_prod(pvt, [torch.tensor(m) for m in mats], paths),
           jgram.vt_mat_prod(jvt, [jnp.asarray(m) for m in mats], paths))
    # K = 0: an empty criterion selection back-projects to empty leaves
    _, empty = pgram.v_mat_prod(pvt, torch.zeros(0, CF * S), paths)
    assert [tuple(e.shape) for e in empty] == [(0, *SHAPES[k]) for k in names]


def test_contractions_match_jax():
    rng = np.random.default_rng(2)
    t = rng.normal(size=(CF, S, 6)).astype(np.float32)
    a, b = rng.normal(size=(2, 3, 7)).astype(np.float32), rng.normal(size=(4, 7)).astype(np.float32)
    _close(pgram.pairwise_dot(torch.tensor(t), start_dim=2), jgram.pairwise_dot(jnp.asarray(t), 2))
    _close(pgram.partial_contract(torch.tensor(a), torch.tensor(b), (2, 1)),
           jgram.partial_contract(jnp.asarray(a), jnp.asarray(b), (2, 1)))
    g4 = rng.normal(size=(CF, S, CF, S)).astype(np.float32)
    assert torch.equal(pgram.reshape_as_square(torch.tensor(g4)),
                       torch.tensor(np.asarray(jgram.reshape_as_square(jnp.asarray(g4)))))
    leaves = [rng.normal(size=(2, 3)).astype(np.float32), rng.normal(size=(2, 2, 2)).astype(np.float32)]
    for g, w in zip(pgram.normalize([torch.tensor(x) for x in leaves]),
                    jgram.normalize([jnp.asarray(x) for x in leaves])):
        _close(g, w)


def test_engine_dispatch_on_generic_dicts():
    """The ``*_any`` helpers on a tensor dict are the ``gram.py`` ones."""
    pvt = {k: torch.tensor(v) for k, v in _vt(3).items()}
    assert not engines.vt_is_mixed(pvt)
    torch.testing.assert_close(engines.gram_any(pvt), pgram.gram_matrix(pvt))
    gv = torch.randn(CF * S, 2, generator=torch.Generator().manual_seed(0))
    back = engines.backproject_any(pvt, gv, list(pvt))
    total = sum(b.reshape(2, -1).square().sum(1) for b in back)
    torch.testing.assert_close(total, torch.ones(2))
    mats = [torch.ones(2, *SHAPES[k]) for k in pvt]
    torch.testing.assert_close(engines.vt_mat_prod_any(pvt, mats, list(pvt)),
                               pgram.vt_mat_prod(pvt, mats))
    with pytest.raises(ValueError, match="needs params="):
        engines.resolve_model(lambda p, x: x)
    with pytest.raises(TypeError, match="nn.Module or a callable"):
        engines.resolve_model(3, {})


def test_tree_helpers_match_jax():
    rng = np.random.default_rng(4)
    tree_np = {k: rng.normal(size=shape).astype(np.float32) for k, shape in sorted(SHAPES.items())}
    jt = {k: jnp.asarray(v) for k, v in tree_np.items()}
    pt = {k: torch.tensor(v) for k, v in tree_np.items()}
    assert ptree.leaf_paths(pt) == jtree.leaf_paths(jt)
    assert [p for p, _ in ptree.flatten_with_paths(pt)] == [p for p, _ in jtree.flatten_with_paths(jt)]
    assert ptree.num_params(pt) == jtree.num_params(jt)
    flat = ptree.ravel(pt)
    _close(flat, jtree.ravel(jt))
    back = ptree.unravel_like(2 * flat, pt)
    for k in pt:
        assert torch.equal(back[k], 2 * pt[k])
    stacked = {k: torch.tensor(np.stack([v, -v])) for k, v in tree_np.items()}
    _close(ptree.ravel_batched(stacked),
           jtree.ravel_batched({k: jnp.asarray(v.numpy()) for k, v in stacked.items()}))
    assert [p for p, _ in ptree.select_paths(pt, ["c_conv", "a_bias"])] == ["c_conv", "a_bias"]
    with pytest.raises(ValueError, match="Parameter paths not found in pytree"):
        ptree.select_paths(pt, ["missing"])
    assert ptree.subtree_mask(pt, ["b_kernel"]) == jtree.subtree_mask(jt, ["b_kernel"])
    taken = ptree.tree_take(stacked, [1], axis=0)
    for k in stacked:
        assert torch.equal(taken[k], stacked[k][[1]])
