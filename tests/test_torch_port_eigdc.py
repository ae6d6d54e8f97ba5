"""The port's spectral D&C eigensolver on the chain path (``n < 1536``) in
eigenvalues mode, and the pieces of its eigenvector-mode polish, against the
JAX package and against float64.

The two packages draw different random numbers (``torch.Generator`` against
``jax.random``), so they agree to the library's eigenvalue tolerance, not
bit for bit.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivit_tpu.eigdc import _apply_blockdiag as jax_apply_blockdiag
from vivit_tpu.eigdc import _dm_iteration as jax_dm_iteration
from vivit_tpu.eigdc import eigvalsh_dc as jax_eigvalsh_dc

from vivit_tpu_torch.eig import full_eigh, topk_eigh
from vivit_tpu_torch.eigdc import _apply_blockdiag, _dm_iteration, eigh_dc, eigvalsh_dc

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


@pytest.mark.parametrize("n,name", CASES, ids=[f"{name}-{n}" for n, name in CASES])
def test_eigvalsh_dc_matches_jax_and_f64(n, name):
    A = _spectrum_matrix(SPECTRA[name](n))
    ref = np.linalg.eigvalsh(A.astype(np.float64))
    got, info = eigvalsh_dc(torch.tensor(A), return_info=True)
    assert not bool(info["tripped"])
    assert float(info["bound"]) < 1e-4 and float(info["orth"]) < 1e-4
    got = got.numpy()
    _assert_close(got, ref)
    want = np.asarray(jax.jit(jax_eigvalsh_dc)(jnp.asarray(A)))
    _assert_close(got, want.astype(np.float64))


def test_small_n_takes_vendor_path():
    """n ≤ max(base, 128) = 160 goes straight to the vendor eigensolver."""
    A = torch.tensor(_spectrum_matrix(np.linspace(0.5, 2.0, 160)))
    got, info = eigvalsh_dc(A, return_info=True)
    assert torch.equal(got, torch.linalg.eigvalsh(0.5 * (A + A.T)))
    assert not bool(info["tripped"]) and float(info["bound"]) == 0.0
    evals, evecs = eigh_dc(A)
    assert evecs.shape == (160, 160)


def test_guard_falls_back_to_vendor():
    """A guard of 0 always trips: the eigenvalues then come from
    ``torch.linalg.eigvalsh`` and a warning says so."""
    A = torch.tensor(_spectrum_matrix(SPECTRA["exp-decay"](200)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, info = eigvalsh_dc(A, guard=0.0, return_info=True)
    assert bool(info["tripped"])
    assert any("guard tripped" in str(w.message) for w in caught)
    assert torch.equal(got, torch.linalg.eigvalsh(0.5 * (A + A.T)))


def test_full_eigh_backends_agree():
    A = torch.tensor(_spectrum_matrix(SPECTRA["ggn-like"](200), seed=3))
    ev_x, vec_x, info_x = full_eigh(A, eigenvectors=True, return_info=True)
    assert vec_x.shape == (200, 200) and not bool(info_x["tripped"])
    ev_d, vec_d = full_eigh(A, backend="dc", eigenvectors=False)
    assert vec_d is None
    _assert_close(ev_d.numpy(), ev_x.double().numpy())
    with pytest.raises(ValueError, match="backend"):
        full_eigh(A, backend="lapack")


def test_unported_modes_raise():
    """Nothing of ``topk_eigh`` raises any more: the LOBPCG top-k solver,
    once unported, gives the top of the spectrum, also through
    ``eigh_topk``, where it agrees with the vendor solver."""
    from vivit_tpu_torch import CNN3c3d, CrossEntropyLoss, eigh_topk

    A = _spectrum_matrix(SPECTRA["exp-decay"](200))
    ev, _ = topk_eigh(torch.tensor(A), 5, solver="lobpcg")
    _assert_close(ev.double().numpy(), np.linalg.eigvalsh(A.astype(np.float64))[-5:])
    X = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = np.array([3, 7], np.int32)
    torch.manual_seed(0)
    model = CNN3c3d()
    got, _ = eigh_topk(model, CrossEntropyLoss(), X, y, 2, solver="lobpcg", device="cpu")
    want, _ = eigh_topk(model, CrossEntropyLoss(), X, y, 2, device="cpu")
    _assert_close(got.double().numpy(), want.double().numpy())


def test_q_carrying_polish_matches_jax():
    """One Davies-Modi step and a block-diagonal rotation on a rectangular
    basis (pad columns), against the JAX package's."""
    rng = np.random.default_rng(6)
    m, rows, w = 96, 80, 32
    Bt = np.diag(np.linspace(0.1, 3.0, m)) + 1e-3 * rng.normal(size=(m, m))
    Bt = ((Bt + Bt.T) / 2).astype(np.float32)
    Q = rng.normal(size=(rows, m)).astype(np.float32)
    V = np.linalg.qr(rng.normal(size=(m // w, w, w)))[0].astype(np.float32)
    got = _apply_blockdiag(torch.tensor(Bt), torch.tensor(Q), torch.tensor(V),
                           0, m, w)
    want = jax_apply_blockdiag(jnp.asarray(Bt), jnp.asarray(Q), jnp.asarray(V),
                               0, m, w)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-5)
    got = _dm_iteration(torch.tensor(Bt), torch.tensor(Q), 2)
    want = jax_dm_iteration(jnp.asarray(Bt), jnp.asarray(Q), None)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5, atol=1e-5)
    Bt_only, none = _dm_iteration(torch.tensor(Bt), None, 2)
    assert none is None and torch.equal(Bt_only, got[0])
