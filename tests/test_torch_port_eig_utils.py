"""Parity of the port's eigenvalue stability helpers (``eig.shift_diag``,
``symeig_psd``, ``symeig``, ``remove_zero_evals``) with the JAX package's,
mirroring ``tests/utils/test_eig.py``: shift invariance on an
ill-conditioned PSD matrix, the rejection of non-2-D input, zero filtering
and the NaN error.  The same numpy matrices go through both packages; the
JAX side runs on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivit_tpu import eig as jax_eig

from vivit_tpu_torch.eig import remove_zero_evals, shift_diag, symeig, symeig_psd

# f32 eigensolves of the same matrix by two LAPACK calls: rtol 1e-5 of the
# spectrum's scale
RTOL, ATOL = 1e-5, 1e-6


def _ill_conditioned_psd(n=32, cond=1e12, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    evals = np.logspace(0, -np.log10(cond), n)
    return (Q @ np.diag(evals) @ Q.T).astype(np.float32), evals[::-1]


@pytest.mark.parametrize("shift", [0.0, 1.0])
def test_symeig_psd_matches_jax(shift):
    mat, evals_true = _ill_conditioned_psd()
    evals, evecs = symeig_psd(torch.tensor(mat), shift=shift)
    want, _ = jax_eig.symeig_psd(jnp.asarray(mat), shift=shift)
    np.testing.assert_allclose(evals.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert evals.shape == (32,) and evecs.shape == (32, 32)
    # shift invariance of the top of the spectrum, as the JAX test holds it
    top = 8
    np.testing.assert_allclose(evals.numpy()[-top:], np.sort(evals_true)[-top:], rtol=1e-3)


def test_symeig_psd_shift_invariance():
    mat, _ = _ill_conditioned_psd()
    evals0, _ = symeig_psd(torch.tensor(mat))
    evals1, _ = symeig_psd(torch.tensor(mat), shift=1.0)
    np.testing.assert_allclose(evals0.numpy()[-8:], evals1.numpy()[-8:], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fn", [symeig_psd, symeig])
def test_rejects_non_2d(fn):
    with pytest.raises(ValueError):
        fn(torch.zeros((2, 2, 2)))


def test_shift_diag():
    mat = torch.eye(3)
    np.testing.assert_array_equal(shift_diag(mat, 2.5).numpy(),
                                  np.asarray(jax_eig.shift_diag(jnp.eye(3), 2.5)))
    assert shift_diag(mat, 0.0) is mat


def test_remove_zero_evals_matches_jax():
    evals = np.asarray([0.0, 1e-9, 0.5, -1e-8, 2.0], np.float32)
    evecs = np.eye(5, dtype=np.float32)
    got_ev, got_V = remove_zero_evals(torch.tensor(evals), torch.tensor(evecs))
    want_ev, want_V = jax_eig.remove_zero_evals(jnp.asarray(evals), jnp.asarray(evecs))
    np.testing.assert_array_equal(got_ev.numpy(), np.asarray(want_ev))
    np.testing.assert_array_equal(got_V.numpy(), np.asarray(want_V))
    assert got_V.shape == (5, 2)
    # no eigenvectors: the empty tensor passes through
    ev, V = remove_zero_evals(torch.tensor(evals), torch.zeros((0,)))
    assert ev.tolist() == [0.5, 2.0] and V.numel() == 0


@pytest.mark.parametrize("eigenvectors", [False, True])
def test_symeig_filters_zeros_like_jax(eigenvectors):
    mat, _ = _ill_conditioned_psd(n=8, cond=1e3)
    low_rank = mat.copy()
    low_rank[:4, :] = 0.0
    low_rank[:, :4] = 0.0
    got_ev, got_V = symeig(torch.tensor(low_rank), eigenvectors=eigenvectors)
    want_ev, want_V = jax_eig.symeig(jnp.asarray(low_rank), eigenvectors=eigenvectors)
    assert got_ev.shape == want_ev.shape == (4,)
    assert bool((got_ev.abs() > 1e-7).all())
    np.testing.assert_allclose(got_ev.numpy(), np.asarray(want_ev), rtol=RTOL, atol=ATOL)
    if eigenvectors:
        assert got_V.shape == want_V.shape == (8, 4)
        # sign-free: |⟨v_port, v_jax⟩| = 1 per kept eigenvector
        dots = np.abs(np.sum(got_V.numpy() * np.asarray(want_V), axis=0))
        np.testing.assert_allclose(dots, 1.0, atol=1e-4)
    else:
        assert got_V.numel() == 0


def test_symeig_raises_on_nan():
    mat = np.eye(4, dtype=np.float32)
    mat[1, 2] = mat[2, 1] = np.nan
    with pytest.raises(RuntimeError, match="NaN"):
        symeig(torch.tensor(mat))
