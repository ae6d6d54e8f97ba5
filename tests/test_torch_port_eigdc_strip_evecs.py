"""The port's spectral D&C eigensolver on the strip path (``n ≥ 1536``) in
eigenvector mode, and the balanced tree of the strip path with real splits,
against float64 and the JAX package's tree.

The two packages draw different random numbers, so they agree to the
library's eigenvalue tolerance, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivit_tpu.eigdc import _make_cfg as jax_make_cfg
from vivit_tpu.eigdc import _tree as jax_tree

from vivit_tpu_torch.eigdc import (
    _deskew,
    _flat_leaves,
    _make_cfg,
    _power_norm,
    _tree,
    eigh_dc,
)

RTOL, ATOL = 1e-4, 5e-6
N = 1536


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ggn_like(n):
    return np.exp(-np.linspace(0, 11, n)) * 250.0 + 1e-7


def _spectrum_matrix(lam, seed=0):
    """``Q diag(lam) Qᵀ`` in f32 for a random orthogonal ``Q``.  The float64
    work of these tests runs in torch, on the one thread the fixture above
    leaves it, not in numpy's thread pool."""
    rng = np.random.default_rng(seed)
    Q, _ = torch.linalg.qr(torch.tensor(rng.standard_normal((len(lam), len(lam)))))
    return ((Q * torch.tensor(lam)) @ Q.T).float().numpy()


def _err_ratio(got, ref):
    err = np.abs(np.asarray(got, np.float64) - ref)
    tol = ATOL * max(1.0, abs(ref[-1])) + RTOL * np.abs(ref)
    return err / tol


def test_strip_eigenvectors_match_f64():
    """The bars of the JAX package's eigenvector tests: top-24 residual and
    orthonormality, the full basis, the global similarity defect."""
    A = torch.tensor(_spectrum_matrix(_ggn_like(N), seed=3))
    A64 = A.double()
    ref = torch.linalg.eigvalsh(A64).numpy()
    ev, V, info = eigh_dc(A, return_info=True)
    assert not bool(info["tripped"])
    ev, V = ev.double(), V.double()
    assert (_err_ratio(ev.numpy(), ref) <= 1.0).all()
    k = 24
    res = torch.linalg.vector_norm(A64 @ V[:, -k:] - V[:, -k:] * ev[-k:], dim=0)
    assert bool((res <= 5e-4 * ev[-1].abs() + 1e-6).all()), res.max()
    eye = torch.eye(N, dtype=torch.float64)
    assert (V[:, -k:].T @ V[:, -k:] - eye[:k, :k]).abs().max() < 5e-3
    assert torch.linalg.matrix_norm(V.T @ V - eye) / N ** 0.5 < 1e-4
    defect = torch.linalg.matrix_norm(A64 @ V - V * ev) / torch.linalg.matrix_norm(A64)
    assert defect < 5e-4, defect


def _tree_ritz(Q, mask, A64):
    """Diagonal-free Ritz values of ``A`` on the tree's valid columns (the
    plain compression ``QvᵀAQv``, as the polish starts from it), and their
    orthonormality defect."""
    Qv = Q[:, mask]
    return (np.linalg.eigvalsh(Qv.T @ A64 @ Qv),
            np.abs(Qv.T @ Qv - np.eye(Qv.shape[1])).max())


def test_tree_with_real_splits_matches_jax_and_f64():
    """``_tree`` alone on a de-skewed node at k=384 with base 160: two
    levels of batched splits (384 → 240 → 150), four leaves.  The valid
    columns are a complete, near-orthonormal basis (so the Rayleigh-Ritz
    values on their span are the float64 spectrum), and the unpolished
    compression is as good as the JAX package's tree on the same node."""
    from scipy.linalg import eigh as generalized_eigh

    k, base = 384, 160
    A = _spectrum_matrix(_ggn_like(k), seed=4)
    A64 = A.astype(np.float64)
    ref = np.linalg.eigvalsh(A64)
    H = torch.tensor(A)
    gen = torch.Generator().manual_seed(0)
    B = _deskew(H, _power_norm(H, gen), gen)
    masks, Q = _tree(B[None], torch.tensor([float(k)]), torch.eye(k)[None], gen,
                     _make_cfg(base=base))
    assert Q.shape == (4, k, 150) and masks.shape == (4, 150)
    assert int(masks.sum()) == k
    Q, mask = _flat_leaves(masks, Q)
    Q, mask = Q.numpy().astype(np.float64), mask.numpy()
    Qv = Q[:, mask]
    sv = np.linalg.svd(Qv, compute_uv=False)
    assert sv.min() > 0.99 and sv.max() < 1.01, (sv.min(), sv.max())
    ritz = generalized_eigh(Qv.T @ A64 @ Qv, Qv.T @ Qv, eigvals_only=True)
    assert (_err_ratio(ritz, ref) <= 1.0).all()
    plain, orth = _tree_ritz(Q, mask, A64)

    # the JAX package's tree on the same node
    cfg = jax_make_cfg(base=base)
    Bj = jnp.asarray(B.numpy())
    _, masks_j, Qj = jax.jit(lambda B, c, L, key: jax_tree(B, c, L, key, cfg))(
        Bj[None], jnp.asarray([k]), jnp.eye(k)[None], jax.random.PRNGKey(0))
    Qj = np.moveaxis(np.asarray(Qj, np.float64), 0, 1).reshape(k, -1)
    plain_j, orth_j = _tree_ritz(Qj, np.asarray(masks_j).reshape(-1), A64)

    assert orth <= 2.0 * orth_j, (orth, orth_j)
    ratio, ratio_j = _err_ratio(plain, ref).max(), _err_ratio(plain_j, ref).max()
    assert ratio <= 2.0 * ratio_j, (ratio, ratio_j)
