"""The routes ``eigh_dc``'s keywords select, against the JAX package called
with the same keywords and against float64: here the recursive chain
(``ladder=False``) at n=384 and 512 in both modes.  The 4-term de-skew
routes are in ``test_torch_port_eigdc_deskew.py``, the sweep tool's
``strip@n``, ``lean-combo`` and the explicit ``tail_merge`` in
``test_torch_port_eigdc_sweep_configs.py``; all three use
:func:`check_route`.

The two packages draw different random numbers, so they agree to the
library's tolerances, not bit for bit.
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


def _assert_close(got, ref):
    err = np.abs(got - ref)
    tol = ATOL * max(1.0, abs(ref[-1])) + RTOL * np.abs(ref)
    assert (err <= tol).all(), (
        f"{int((err > tol).sum())}/{len(ref)} violations, "
        f"max err/tol {(err / tol).max():.2f}"
    )


def _vector_defects(A64, ev, V, k=24):
    """Top-``k`` residuals over their bar ``5e-4·λmax + 1e-6``, top-``k``
    and full orthonormality, ``‖AV − VΛ‖_F/‖A‖_F``."""
    n = len(ev)
    res = np.linalg.norm(A64 @ V[:, -k:] - V[:, -k:] * ev[-k:], axis=0)
    return ((res / (5e-4 * abs(ev[-1]) + 1e-6)).max(),
            np.abs(V[:, -k:].T @ V[:, -k:] - np.eye(k)).max(),
            np.linalg.norm(V.T @ V - np.eye(n)) / np.sqrt(n),
            np.linalg.norm(A64 @ V - V * ev) / np.linalg.norm(A64))


def check_route(n, kw, vectors, seed=3):
    """``eigh_dc(**kw)`` of the port and of the JAX package on the ggn-like
    spectrum at ``n``: both untripped, the port's eigenvalues within the bar
    of float64 and of the JAX package's.  With vectors, the bars of the
    JAX package's eigenvector tests (``test_torch_port_eigdc_evecs.py``):
    top-24 residuals, top-24 and full orthonormality, and the global
    similarity defect, which may reach the JAX package's where that misses
    5e-4; the top-10 vectors against the JAX package's up to sign."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = ((Q * (np.exp(-np.linspace(0, 11, n)) * 250.0 + 1e-7)) @ Q.T).astype(np.float32)
    A64 = A.astype(np.float64)
    ref = np.linalg.eigvalsh(A64)
    ev, V, info = eigh_dc(torch.tensor(A), eigenvectors=vectors, return_info=True, **kw)
    ev_j, V_j, info_j = jax.jit(lambda H: jax_eigh_dc(
        H, eigenvectors=vectors, return_info=True, **kw))(jnp.asarray(A))
    assert not bool(info["tripped"]) and not bool(info_j["tripped"])
    ev, ev_j = ev.double().numpy(), np.asarray(ev_j, np.float64)
    _assert_close(ev, ref)
    _assert_close(ev, ev_j)
    if not vectors:
        assert V is None
        return
    V, V_j = V.double().numpy(), np.asarray(V_j, np.float64)
    res, orth_k, orth, defect = _vector_defects(A64, ev, V)
    defect_j = _vector_defects(A64, ev_j, V_j)[3]
    assert res <= 1.0 and orth_k < 5e-3 and orth < 1e-4, (res, orth_k, orth)
    assert defect < max(5e-4, 1.5 * defect_j), (defect, defect_j)
    top, top_j = V[:, -10:], V_j[:, -10:]
    sign = np.sign(np.sum(top * top_j, axis=0))
    np.testing.assert_allclose(top * sign, top_j, rtol=2e-2, atol=2e-3)


CASES = [(n, vectors) for n in (384, 512) for vectors in (False, True)]


@pytest.mark.parametrize("n,vectors", CASES,
                         ids=[f"{n}-{'eigenpairs' if v else 'eigenvalues'}" for n, v in CASES])
def test_recursive_chain_matches_jax_and_f64(n, vectors):
    """``ladder=False``: the recursive ``_basis`` chain at the root, the
    JAX package's round-4 design, in place of the level-synchronous
    ladder."""
    check_route(n, {"ladder": False}, vectors)
