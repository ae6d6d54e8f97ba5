"""The port's spectral D&C eigensolver on the chain path (``n < 1536``) in
eigenvector mode, against the JAX package's ``eigh_dc`` and against float64.

The two packages draw different random numbers (``torch.Generator`` against
``jax.random``), so they agree to the library's eigenvalue tolerance, not
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivit_tpu.eigdc import eigh_dc as jax_eigh_dc

from vivit_tpu_torch.eigdc import eigh_dc

RTOL, ATOL = 1e-4, 5e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spectrum_matrix(lam, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((len(lam), len(lam))))
    return ((Q * lam) @ Q.T).astype(np.float32)


SPECTRA = {
    "ggn-like": lambda n: np.exp(-np.linspace(0, 11, n)) * 250.0 + 1e-7,
    "exp-decay": lambda n: np.exp(-np.arange(n) / 40.0) + 1e-9,
}
CASES = [(n, name) for n in (384, 512) for name in SPECTRA]


def _assert_close(got, ref):
    err = np.abs(got - ref)
    tol = ATOL * max(1.0, abs(ref[-1])) + RTOL * np.abs(ref)
    assert (err <= tol).all(), (
        f"{int((err > tol).sum())}/{len(ref)} violations, "
        f"max err/tol {(err / tol).max():.2f}"
    )


_jax_eigh = jax.jit(lambda H: jax_eigh_dc(H, return_info=True))


@pytest.mark.parametrize("n,name", CASES, ids=[f"{name}-{n}" for n, name in CASES])
def test_eigh_dc_eigenvectors_match_jax_and_f64(n, name):
    """Eigenvector mode on the chain path: values against float64 and the
    JAX package, the bars of the JAX package's own eigenvector tests, and
    the top-10 vectors against the JAX package's up to sign."""
    A = _spectrum_matrix(SPECTRA[name](n), seed=3)
    ref = np.linalg.eigvalsh(A.astype(np.float64))
    ev, V, info = eigh_dc(torch.tensor(A), return_info=True)
    assert not bool(info["tripped"])
    ev, V = ev.numpy().astype(np.float64), V.numpy().astype(np.float64)
    _assert_close(ev, ref)
    ev_j, V_j, _ = _jax_eigh(jnp.asarray(A))
    _assert_close(ev, np.asarray(ev_j, np.float64))

    A64, lmax = A.astype(np.float64), abs(ev[-1])
    k = 24
    res = np.linalg.norm(A64 @ V[:, -k:] - V[:, -k:] * ev[-k:], axis=0)
    assert np.all(res <= 5e-4 * lmax + 1e-6), res.max()
    assert np.abs(V[:, -k:].T @ V[:, -k:] - np.eye(k)).max() < 5e-3
    assert np.linalg.norm(V.T @ V - np.eye(n)) / np.sqrt(n) < 1e-4
    assert np.linalg.norm(A64 @ V - V * ev) / np.linalg.norm(A64) < 5e-4

    top, top_j = V[:, -10:], np.asarray(V_j, np.float64)[:, -10:]
    sign = np.sign(np.sum(top * top_j, axis=0))
    np.testing.assert_allclose(top * sign, top_j, rtol=2e-2, atol=2e-3)
