"""The port's batched Jacobi (plain version) against the JAX package's Pallas
kernel, which runs in interpret mode on the CPU, and against float64.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the same plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivit_tpu.kernels import jacobi as jax_jacobi
from vivit_tpu.kernels.jacobi_pallas import batched_eigh_jacobi as pallas_jacobi

import vivit_tpu_torch.eigdc as port_eigdc
from vivit_tpu_torch.kernels.jacobi import batched_eigh, jacobi_supported
from vivit_tpu_torch.kernels.jacobi_cuda import (
    SWEEPS,
    batched_eigh_jacobi,
    batched_eigh_jacobi_cuda,
    batched_eigh_jacobi_plain,
    bound_ms,
    round_robin_pairs,
    schedule_table,
)

SHAPES = [(5, 32), (37, 32), (4, 48), (2, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once: torch's intra-op
    thread pool in each would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_sym(b, m, seed):
    A = np.random.default_rng(seed).normal(size=(b, m, m)).astype(np.float32)
    return (A + A.transpose(0, 2, 1)) / 2


def _separated(b, m, seed):
    """Symmetric matrices with eigenvalues spaced 2/m apart in [-1, 1]."""
    rng = np.random.default_rng(seed)
    lam = np.linspace(-1.0, 1.0, m)
    out = []
    for _ in range(b):
        Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
        out.append((Q * lam) @ Q.T)
    return np.asarray(out, np.float32)


def _check_f64_bars(A, ev, V):
    """The bars of tests/test_eigdc.py: eigenvalues within 1e-4 of float64,
    residual ‖AV − VΛ‖_F < 1e-3, max|VᵀV − I| < 1e-4."""
    ref = np.linalg.eigvalsh(A.astype(np.float64))
    assert np.abs(ev - ref).max() < 1e-4
    m = A.shape[-1]
    for i in range(A.shape[0]):
        assert np.linalg.norm(A[i] @ V[i] - V[i] * ev[i][None, :]) < 1e-3
        assert np.abs(V[i].T @ V[i] - np.eye(m)).max() < 1e-4


@pytest.mark.parametrize("b,m", SHAPES, ids=[f"{b}x{m}" for b, m in SHAPES])
def test_plain_matches_pallas_eigenvalues(b, m):
    A = _random_sym(b, m, seed=m + b)
    ev, V = (t.numpy() for t in batched_eigh_jacobi_plain(torch.tensor(A)))
    ev_p, _ = pallas_jacobi(jnp.asarray(A))
    norm = np.abs(np.linalg.eigvalsh(A.astype(np.float64))).max(axis=-1)
    assert (np.abs(ev - np.asarray(ev_p)).max(axis=-1) <= 1e-5 * norm).all()
    _check_f64_bars(A, ev, V)


@pytest.mark.parametrize("b,m", SHAPES, ids=[f"{b}x{m}" for b, m in SHAPES])
def test_plain_matches_pallas_eigenvectors(b, m):
    A = _separated(b, m, seed=m)
    ev, V = (t.numpy() for t in batched_eigh_jacobi_plain(torch.tensor(A)))
    _, V_p = pallas_jacobi(jnp.asarray(A))
    overlap = np.abs(np.einsum("bki,bkj->bij", np.asarray(V_p), V))
    assert np.abs(overlap - np.eye(m)).max() < 1e-4
    _check_f64_bars(A, ev, V)


def test_equal_diagonal_takes_45_degree_rotation():
    """tau == 0 (equal diagonal, non-zero off-diagonal) must rotate: every
    pair of the first sweep starts at tau == 0."""
    m = 32
    A = _random_sym(3, m, seed=7)
    for a in A:
        np.fill_diagonal(a, 1.0)
    ev, V = (t.numpy() for t in batched_eigh_jacobi_plain(torch.tensor(A)))
    ev_p, _ = pallas_jacobi(jnp.asarray(A))
    _check_f64_bars(A, ev, V)
    norm = np.abs(np.linalg.eigvalsh(A.astype(np.float64))).max()
    np.testing.assert_allclose(ev, np.asarray(ev_p), atol=1e-5 * norm)


def test_all_equal_couplings_converge():
    """``0.5·J + 1.5·I``: tau == 0 for every pair of every early step, and
    one 31-fold eigenvalue.  Held against float64 only: the Pallas kernel
    returns eigenvalues off by up to 1.5 here (ROADMAP, faults)."""
    m = 32
    A = (np.full((1, m, m), 0.5) + 1.5 * np.eye(m)).astype(np.float32)
    ev, V = (t.numpy() for t in batched_eigh_jacobi_plain(torch.tensor(A)))
    _check_f64_bars(A, ev, V)


def test_diagonal_input_is_left_alone():
    """|a_pq| <= 1e-30 takes the identity: a diagonal input comes back
    exactly, with a permutation for eigenvectors."""
    d = np.random.default_rng(2).normal(size=(3, 32)).astype(np.float32)
    A = np.stack([np.diag(x) for x in d])
    ev, V = (t.numpy() for t in batched_eigh_jacobi_plain(torch.tensor(A)))
    np.testing.assert_array_equal(ev, np.sort(d, axis=-1))
    np.testing.assert_array_equal(np.abs(V).sum(axis=1), np.ones((3, 32)))


@pytest.mark.parametrize("m", [2, 8, 32, 64])
def test_round_robin_meets_every_pair_once(m):
    P, Q = round_robin_pairs(m)
    pairs = list(zip(P.flatten().tolist(), Q.flatten().tolist()))
    assert len(pairs) == len(set(pairs)) == m * (m - 1) // 2
    assert all(p < q for p, q in pairs)
    # each step's pairs are disjoint
    steps = torch.cat([P, Q], dim=1)
    assert all(len(set(row)) == m for row in steps.tolist())


def test_batched_eigh_routes_windows_to_jacobi():
    """The H100's envelope sends the headline windows, the N=512 strip
    windows (b·m > 2048, outside the TPU's envelope) and single matrices of
    the compiled sizes to the Jacobi path, and the ladder leaves, the bottom
    block, float64 and sizes the kernel was not compiled for to the vendor
    eigensolver."""
    assert jacobi_supported((37, 32, 32), torch.float32)
    assert jacobi_supported((36, 32, 32), torch.float32)
    assert jacobi_supported((73, 64, 64), torch.float32)
    assert jacobi_supported((1, 48, 48), torch.float32)
    assert not jacobi_supported((1, 96, 96), torch.float32)
    assert not jacobi_supported((16, 150, 150), torch.float32)
    assert not jacobi_supported((37, 32, 32), torch.float64)
    assert not jacobi_supported((37, 80, 80), torch.float32)

    A = torch.tensor(_random_sym(37, 32, seed=0))
    for got, want in zip(batched_eigh(A), batched_eigh_jacobi_plain(A)):
        assert torch.equal(got, want)
    for b, m in ((1, 96), (16, 150)):
        A = torch.tensor(_random_sym(b, m, seed=m))
        for got, want in zip(batched_eigh(A), torch.linalg.eigh(A)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("shape,kernel", [
    ((438, 64, 64), True),
    ((4096, 32, 32), True),
    ((8, 421, 421), False),
    ((16, 150, 150), False),
    ((1, 714, 714), False),
    ((2, 1024, 1024), False),
    ((73, 64, 32), False),
], ids=lambda x: str(x))
def test_jacobi_envelope(shape, kernel):
    """The kernel takes f32 ``[b, m, m]`` of its compiled sizes at any b
    (it beat ``torch.linalg.eigh`` at every b measured on the H100); the
    paths' leaves and any other shape take one batched call."""
    assert jacobi_supported(shape, torch.float32) == kernel


LARGE_SHAPES = [(2, 256), (3, 272)]


@pytest.mark.parametrize("b,m", LARGE_SHAPES, ids=[f"{b}x{m}" for b, m in LARGE_SHAPES])
def test_large_blocks_match_jax_map(b, m):
    """At blocks the JAX package sends to its ``lax.map`` of single solves
    (b > 1, m >= its ``_MAP_MIN_K``), the port's one batched call is the
    same function: seeded numpy inputs with eigenvalues 2/m apart,
    eigenvalues at BASELINE's bar (rtol 1e-4, atol 5e-6·λmax), eigenvectors
    up to sign within 1e-4 (f32 at that gap)."""
    assert m >= jax_jacobi._MAP_MIN_K
    A = _separated(b, m, seed=11 + m)
    ev, V = (t.numpy() for t in batched_eigh(torch.tensor(A)))
    ev_j, V_j = (np.asarray(t) for t in jax_jacobi.batched_eigh(jnp.asarray(A)))
    lmax = np.abs(ev_j).max(axis=-1, keepdims=True)
    assert (np.abs(ev - ev_j) <= 5e-6 * lmax + 1e-4 * np.abs(ev_j)).all()
    overlap = np.abs(np.einsum("bki,bkj->bij", V_j, V))
    assert np.abs(overlap - np.eye(m)).max() < 1e-4


def test_cpu_tensor_takes_plain_version():
    A = torch.tensor(_random_sym(2, 32, seed=4))
    for got, want in zip(batched_eigh_jacobi(A), batched_eigh_jacobi_plain(A)):
        assert torch.equal(got, want)


def test_kernel_wrapper_rejects_what_it_cannot_take():
    with pytest.raises(ValueError, match="CUDA tensor"):
        batched_eigh_jacobi_cuda(torch.zeros(2, 32, 32))
    with pytest.raises(ValueError, match="compiled for m = 32, 48 or 64"):
        batched_eigh_jacobi_cuda(torch.zeros(2, 34, 34))
    with pytest.raises(ValueError, match="even"):
        batched_eigh_jacobi_plain(torch.zeros(2, 33, 33))
    with pytest.raises(ValueError, match="m <= 64"):
        batched_eigh_jacobi_plain(torch.zeros(1, 66, 66))
    with pytest.raises(TypeError, match="float32"):
        batched_eigh_jacobi_plain(torch.zeros(1, 32, 32, dtype=torch.float64))


@pytest.mark.parametrize("m", [2, 16, 62])
def test_kernel_wrapper_takes_only_the_compiled_sizes(m):
    """The plain version takes any even m <= 64; the kernel is compiled for
    the envelope's m only, and its wrapper says so before it looks at the
    device."""
    A = torch.tensor(_random_sym(1, m, seed=m))
    batched_eigh_jacobi_plain(A)
    with pytest.raises(ValueError, match="compiled for m = 32, 48 or 64"):
        batched_eigh_jacobi_cuda(A)


@pytest.mark.parametrize("m", [8, 32, 48, 64])
def test_schedule_table_is_the_round_robin(m):
    """The table the wrapper hands the kernel: pair j of step r is
    round_robin_pairs' pair, and its lookahead fields name the block of step
    r that holds the pivot of pair j at step r+1 (step 0 after the last)."""
    P, Q = round_robin_pairs(m)
    table = schedule_table(m)
    assert table.dtype == torch.int32 and table.shape == (m - 1, m // 2)
    assert torch.equal(table & 0xFF, P) and torch.equal((table >> 8) & 0xFF, Q)
    meta = table >> 16
    kr, a = meta & 31, (meta >> 5) & 1
    kc, b = (meta >> 6) & 31, (meta >> 11) & 1
    for r in range(m - 1):
        nxt = (r + 1) % (m - 1)
        rows = torch.where(a[r] == 1, Q[r, kr[r]], P[r, kr[r]])
        cols = torch.where(b[r] == 1, Q[r, kc[r]], P[r, kc[r]])
        assert torch.equal(rows, P[nxt]) and torch.equal(cols, Q[nxt])


EXIT_SHAPES = [(5, 32), (4, 48), (2, 64)]


def _both_ways(A):
    full = batched_eigh_jacobi_plain(A, return_sweeps=True)
    short = batched_eigh_jacobi_plain(A, exit_early=True, return_sweeps=True)
    return full, short


@pytest.mark.parametrize("b,m", EXIT_SHAPES, ids=[f"{b}x{m}" for b, m in EXIT_SHAPES])
def test_exit_rule_returns_the_12_sweep_result(b, m):
    """After a sweep in which every rotation was the identity, every later
    sweep is the identity: stopping there gives the 12-sweep outputs."""
    full, short = _both_ways(torch.tensor(_random_sym(b, m, seed=3 * m + b)))
    for got, want in zip(short, full):
        assert torch.equal(got, want)
    assert full[2].dtype == torch.int32 and bool((full[2] <= SWEEPS).all())


@pytest.fixture(scope="module")
def solver_windows():
    """The window batches that the port's eigvalsh_dc hands the Jacobi
    path at n=384 on the ggn-like spectrum."""
    rng = np.random.default_rng(0)
    n = 384
    Qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.exp(-np.linspace(0, 11, n)) * 250.0 + 1e-7
    H = torch.tensor(((Qm * lam) @ Qm.T).astype(np.float32))
    seen = []

    def recording(A):
        if jacobi_supported(A.shape, A.dtype):
            seen.append(A.clone())
        return batched_eigh(A)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_eigdc, "batched_eigh", recording)
            port_eigdc.eigvalsh_dc(H)
    finally:
        torch.set_num_threads(threads)
    assert seen
    return seen


def test_exit_rule_returns_the_12_sweep_result_on_solver_windows(solver_windows):
    for A in solver_windows:
        full, short = _both_ways(A)
        for got, want in zip(short, full):
            assert torch.equal(got, want)


def test_solver_windows_exit_before_12_sweeps(solver_windows):
    for A in solver_windows:
        _, _, sweeps = batched_eigh_jacobi_plain(A, exit_early=True, return_sweeps=True)
        assert int(sweeps.max()) < SWEEPS


def test_diagonal_input_exits_after_one_sweep():
    d = np.random.default_rng(5).normal(size=(2, 32)).astype(np.float32)
    A = torch.tensor(np.stack([np.diag(x) for x in d]))
    ev, _, sweeps = batched_eigh_jacobi_plain(A, exit_early=True, return_sweeps=True)
    assert torch.equal(sweeps, torch.ones(2, dtype=torch.int32))
    assert torch.equal(ev, torch.sort(torch.tensor(d), dim=-1).values)


def test_bound_counts_the_sweeps_run():
    """The operations bound scales with the matrix-sweeps run; the bytes
    bound does not depend on them."""
    full, by = bound_ms(37, 32, 37 * SWEEPS, 67e12, 3.35e12)
    half, _ = bound_ms(37, 32, 37 * SWEEPS // 2, 67e12, 3.35e12)
    assert by == "operations" and half == pytest.approx(full / 2)
    none, by0 = bound_ms(37, 32, 0, 67e12, 3.35e12)
    assert by0 == "bytes" and none > 0


SWEEP_CASES = [(s, b, m) for s in (8, 12) for b, m in ((4, 32), (2, 64))]


@pytest.mark.parametrize("sweeps,b,m", SWEEP_CASES,
                         ids=[f"{s}-sweeps-{b}x{m}" for s, b, m in SWEEP_CASES])
def test_plain_matches_pallas_at_sweeps(sweeps, b, m):
    """``sweeps`` caps the plain version's loop as it caps the Pallas
    kernel's.  Held together where both have converged (eigenvalues spaced
    2/m apart converge in 8 sweeps to f32, though the exact exit rule needs
    9-10): the two orderings differ only before that."""
    A = _separated(b, m, seed=sweeps + m)
    ev, V, ran = (t.numpy() for t in batched_eigh_jacobi_plain(
        torch.tensor(A), return_sweeps=True, sweeps=sweeps))
    # the exact exit needs 9-10 sweeps: 8 is the cap, 12 is not reached
    assert (ran == 8).all() if sweeps == 8 else (ran < sweeps).all()
    ev_p, V_p = pallas_jacobi(jnp.asarray(A), sweeps=sweeps)
    norm = np.abs(np.linalg.eigvalsh(A.astype(np.float64))).max(axis=-1)
    assert (np.abs(ev - np.asarray(ev_p)).max(axis=-1) <= 1e-5 * norm).all()
    overlap = np.abs(np.einsum("bki,bkj->bij", np.asarray(V_p), V))
    assert np.abs(overlap - np.eye(m)).max() < 1e-4
    _check_f64_bars(A, ev, V)
    for got, want in zip(batched_eigh_jacobi(torch.tensor(A), sweeps=sweeps),
                         batched_eigh_jacobi_plain(torch.tensor(A), sweeps=sweeps)):
        assert torch.equal(got, want)


def test_plain_runs_one_sweep():
    """At ``sweeps=1`` every matrix runs one sweep: every pair rotated once,
    the result short of the converged one, with or without the exit rule."""
    A = torch.tensor(_random_sym(3, 32, seed=11))
    one = batched_eigh_jacobi_plain(A, return_sweeps=True, sweeps=1)
    assert torch.equal(one[2], torch.ones(3, dtype=torch.int32))
    for got, want in zip(batched_eigh_jacobi_plain(A, exit_early=True, return_sweeps=True,
                                                   sweeps=1), one):
        assert torch.equal(got, want)
    two = batched_eigh_jacobi_plain(A, sweeps=2)
    assert not torch.equal(one[0], two[0])
    ref = torch.linalg.eigvalsh(A.double())
    assert (one[0].double() - ref).abs().max() > (two[0].double() - ref).abs().max()
    with pytest.raises(ValueError, match="sweep"):
        batched_eigh_jacobi_plain(A, sweeps=0)
