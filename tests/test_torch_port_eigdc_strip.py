"""The port's spectral D&C eigensolver on the strip path (``n ≥ 1536``) in
eigenvalues mode, against the JAX package and against float64.

The two packages draw different random numbers, so they agree to the
library's eigenvalue tolerance, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivit_tpu.eigdc import eigvalsh_dc as jax_eigvalsh_dc

from vivit_tpu_torch.eigdc import eigvalsh_dc

RTOL, ATOL = 1e-4, 5e-6
N = 1536

# Quantile anchors of the real N=512 CE Gram spectrum of CIFAR-10 3c3d, the
# profile of the JAX package's strip tests (tests/test_eigdc.py): 10% exact
# zeros, most of the mass near 1e-4·λmax, a sparse four-decade top band.
_BENCH512_QS = [0.0, 0.04, 0.08, 0.12, 0.16, 0.2, 0.24, 0.28, 0.32, 0.36,
                0.4, 0.44, 0.48, 0.52, 0.56, 0.6, 0.64, 0.68, 0.72, 0.76,
                0.8, 0.84, 0.88, 0.92, 0.96, 0.97, 0.98, 0.99, 0.995,
                0.999, 1.0]
_BENCH512_ANCHORS = [2.0134e-07, 2.58318e-07, 2.81113e-07, 0.00291111,
                     0.00351954, 0.00410348, 0.00469892, 0.00533082,
                     0.00600511, 0.00672642, 0.00750231, 0.00832668,
                     0.00918823, 0.0101112, 0.0110853, 0.0121278,
                     0.0132795, 0.0145753, 0.016074, 0.0178777, 0.020194,
                     0.0234804, 0.0290798, 0.0435664, 0.134796, 0.215596,
                     0.395891, 0.938176, 1.70846, 112.886, 250.119]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bench512_profile(n):
    lam = np.interp(np.linspace(0, 1, n), _BENCH512_QS, _BENCH512_ANCHORS)
    lam[: n // 10] = 0.0  # CE exact-zero block
    return lam


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


@pytest.fixture(scope="module")
def bench_matrix():
    A = _spectrum_matrix(_bench512_profile(N))
    return A, torch.linalg.eigvalsh(torch.tensor(A).double()).numpy()


def test_strip_eigvalsh_raw_matches_f64(bench_matrix):
    """Without the guard: the raw strip-path values meet the bar, so the
    guard's fallback cannot hide a regression."""
    A, ref = bench_matrix
    got = eigvalsh_dc(torch.tensor(A), guard=None).numpy()
    ratio = _err_ratio(got, ref)
    assert (ratio <= 1.0).all(), f"{int((ratio > 1).sum())}/{N}, max {ratio.max():.2f}"


def test_strip_eigvalsh_guarded_matches_jax_and_f64(bench_matrix):
    A, ref = bench_matrix
    got, info = eigvalsh_dc(torch.tensor(A), return_info=True)
    assert not bool(info["tripped"])
    assert float(info["bound"]) < 1e-4 and float(info["orth"]) < 1e-4
    got = got.numpy()
    assert (_err_ratio(got, ref) <= 1.0).all()
    want = np.asarray(jax.jit(jax_eigvalsh_dc)(jnp.asarray(A)), np.float64)
    assert (_err_ratio(got, want) <= 1.0).all()
