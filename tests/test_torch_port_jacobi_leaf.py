"""The leaf route of the port's ``batched_eigh``
(``vivit_tpu_torch.kernels.jacobi_leaf_cuda``): its plain version against
the JAX package's ``batched_eigh`` (``jnp.linalg.eigh`` at these sizes on
the CPU) and float64, the pad of an odd ``m``, the route rule, the
wrapper's input errors, and a whole ``eigh_dc`` with its leaves and edge
blocks on the plain leaf solve.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the same plain version there, bit for bit.  On the CPU the route
sends the leaf range to ``torch.linalg.eigh``, so the ``eigh_dc`` test
patches the rule to take the card's route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivit_tpu.eigdc import eigh_dc as jax_eigh_dc
from vivit_tpu.kernels import jacobi as jax_jacobi

from tests.test_torch_port_eigdc_graphs import _in_segments, _trap_host_reads
from vivit_tpu_torch import eigdc
from vivit_tpu_torch.kernels import jacobi
from vivit_tpu_torch.kernels.jacobi_cuda import jacobi_sweeps_plain
from vivit_tpu_torch.kernels.jacobi_leaf_cuda import (
    LEAF_MAX_M,
    batched_eigh_leaf,
    batched_eigh_leaf_cuda,
    batched_eigh_leaf_plain,
)
from vivit_tpu_torch.utils import graphs

# BASELINE.md: eigenvalues rtol 1e-4 / atol 5e-6·λmax; G v = λ v and
# orthonormality at 5e-4; vectors up to sign rtol 2e-2 / atol 2e-3
RTOL, ATOL = 1e-4, 5e-6
RES_RTOL = 5e-4
VEC_RTOL, VEC_ATOL = 2e-2, 2e-3
CUDA, CPU = torch.device("cuda"), torch.device("cpu")


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


def _assert_eigenvalues(ev, ref):
    """``ev`` within BASELINE's eigenvalue bar of ``ref`` (per matrix)."""
    lmax = np.abs(ref).max(axis=-1, keepdims=True)
    err, tol = np.abs(ev - ref), ATOL * lmax + RTOL * np.abs(ref)
    assert (err <= tol).all(), f"max err/tol {(err / tol).max():.2f}"


LEAF_CASES = [(b, m) for m in (7, 40, 96, 150, 160) for b in (1, 2)]


@pytest.mark.parametrize("b,m", LEAF_CASES, ids=[f"{b}x{m}" for b, m in LEAF_CASES])
def test_plain_leaf_matches_jax_batched_eigh(b, m):
    """The plain leaf solve against the JAX package's ``batched_eigh`` and
    float64: eigenvalues at BASELINE's bar, ``A v = λ v`` and
    orthonormality at 5e-4, and the vectors up to sign where the gaps
    allow (a gap of at least 1e-2·λmax to both neighbours)."""
    A = _random_sym(b, m, seed=b * 1000 + m)
    ev, V = (t.numpy().astype(np.float64) for t in batched_eigh_leaf_plain(torch.tensor(A)))
    ev_j, V_j = (np.asarray(t, np.float64) for t in jax_jacobi.batched_eigh(jnp.asarray(A)))
    A64 = A.astype(np.float64)
    _assert_eigenvalues(ev, np.linalg.eigvalsh(A64))
    _assert_eigenvalues(ev, ev_j)
    lmax = np.abs(ev).max(axis=-1)
    res = np.linalg.norm(A64 @ V - V * ev[:, None, :], axis=1)
    assert (res <= RES_RTOL * lmax[:, None]).all(), res.max()
    eye = np.eye(m)
    assert np.abs(np.swapaxes(V, 1, 2) @ V - eye).max() <= RES_RTOL
    gaps = np.diff(ev, axis=-1)
    inf = np.full((b, 1), np.inf)
    lone = np.minimum(np.concatenate([inf, gaps], -1), np.concatenate([gaps, inf], -1))
    lone = lone >= 1e-2 * lmax[:, None]
    assert lone.sum() >= m // 4  # the comparison covers most vectors
    sign = np.sign(np.sum(V * V_j, axis=1, keepdims=True))
    np.testing.assert_allclose((V * sign)[np.repeat(lone[:, None, :], m, 1)],
                               V_j[np.repeat(lone[:, None, :], m, 1)],
                               rtol=VEC_RTOL, atol=VEC_ATOL)


@pytest.mark.parametrize("m", [7, 95, 159])
def test_pad_of_an_odd_m_stays_decoupled(m):
    """An odd ``m`` runs padded by a zero row and column: after every sweep
    the pad's row and column of ``V`` are exactly zero off its diagonal, its
    diagonal exactly one and its eigenvalue exactly zero, and the pad is
    dropped: the result is ``[b, m]`` and ``[b, m, m]``."""
    b = 2 if m < 100 else 1
    A = torch.tensor(_random_sym(b, m, seed=m))
    Ap = torch.nn.functional.pad(A, (0, 1, 0, 1))
    d, V, ran = jacobi_sweeps_plain(Ap, max_m=LEAF_MAX_M)
    assert torch.equal(V[:, m, :m], torch.zeros(b, m))
    assert torch.equal(V[:, :m, m], torch.zeros(b, m))
    assert torch.equal(V[:, m, m], torch.ones(b))
    assert torch.equal(d[:, m], torch.zeros(b))
    ev, evecs, ran_leaf = batched_eigh_leaf_plain(A, return_sweeps=True)
    assert ev.shape == (b, m) and evecs.shape == (b, m, m)
    assert torch.equal(ran_leaf, ran)
    assert torch.equal(ev, torch.sort(d[:, :m], dim=-1).values)


ROUTES = [
    ((37, 32, 32), torch.float32, "window", "window"),
    ((16, 150, 150), torch.float32, "leaf", "vendor"),
    ((1, 96, 96), torch.float32, "leaf", "vendor"),
    ((1, 160, 160), torch.float32, "leaf", "vendor"),
    ((1, 162, 162), torch.float32, "vendor", "vendor"),
    ((1, 240, 240), torch.float32, "vendor", "vendor"),
    ((16, 150, 150), torch.float64, "vendor", "vendor"),
    ((37, 32, 32), torch.float64, "vendor", "vendor"),
]


@pytest.mark.parametrize("shape,dtype,on_cuda,on_cpu", ROUTES,
                         ids=[f"{s}-{str(d)[6:]}" for s, d, _, _ in ROUTES])
def test_route_rule_at_the_edges_of_its_envelope(shape, dtype, on_cuda, on_cpu):
    """The window kernel at m in {32, 48, 64} on either device; the leaf
    kernel at any other f32 m <= 160 on a CUDA device; the vendor above 160,
    for float64, and for the leaf range on the CPU."""
    assert jacobi.route(shape, dtype, CUDA) == on_cuda
    assert jacobi.route(shape, dtype, CPU) == on_cpu
    assert jacobi.route(shape, dtype, "cuda:0") == on_cuda


SINGLES = [
    ((1, 66, 66), "leaf"),
    ((1, 72, 72), "vendor"),
    ((1, 95, 95), "vendor"),
    ((1, 160, 160), "vendor"),
    ((2, 160, 160), "leaf"),
    ((16, 150, 150), "leaf"),
    ((1, 64, 64), "window"),
    ((1, 240, 240), "vendor"),
]


@pytest.mark.parametrize("shape,eager_on_cuda", SINGLES, ids=[str(s) for s, _ in SINGLES])
def test_single_matrix_outside_graphs_goes_to_the_vendor(shape, eager_on_cuda):
    """Solved outside any graph (``eager``), a single matrix of the leaf
    range with ``m >= 72`` takes the vendor on the card; a batch, a smaller
    matrix and the window sizes keep their routes, and inside a graph
    (the default) every one keeps the leaf kernel."""
    assert jacobi.route(shape, torch.float32, CUDA, eager=True) == eager_on_cuda
    inside = jacobi.route(shape, torch.float32, CUDA)
    assert inside == ("vendor" if shape[-1] > LEAF_MAX_M else
                      "window" if shape[-1] == 64 else "leaf")
    assert jacobi.route(shape, torch.float32, CPU, eager=True) == jacobi.route(
        shape, torch.float32, CPU)


def test_outside_graphs_is_what_batched_eigh_routes_by(monkeypatch):
    """``batched_eigh`` asks the rule with ``eager`` true inside
    ``outside_graphs`` (nested too) and false outside it."""
    asked = []
    rule = jacobi.route

    def noted(shape, dtype, device, eager=False):
        asked.append(eager)
        return rule(shape, dtype, device, eager)

    monkeypatch.setattr(jacobi, "route", noted)
    A = torch.tensor(_random_sym(1, 40, seed=5))
    jacobi.batched_eigh(A)
    with jacobi.outside_graphs():
        jacobi.batched_eigh(A)
        with jacobi.outside_graphs():
            jacobi.batched_eigh(A)
        jacobi.batched_eigh(A)
    jacobi.batched_eigh(A)
    assert asked == [False, True, True, True, False]


def test_cpu_tensor_of_the_leaf_range_takes_the_vendor():
    """``batched_eigh`` on a CPU tensor of the leaf range is
    ``torch.linalg.eigh``, bit for bit; ``batched_eigh_leaf`` on it is the
    plain version."""
    A = torch.tensor(_random_sym(2, 40, seed=4))
    for got, want in zip(jacobi.batched_eigh(A), torch.linalg.eigh(A)):
        assert torch.equal(got, want)
    for got, want in zip(batched_eigh_leaf(A), batched_eigh_leaf_plain(A)):
        assert torch.equal(got, want)


def test_leaf_wrapper_rejects_what_it_cannot_take():
    """The kernel's wrapper checks dtype, shape and size before the device,
    then the device; the plain version checks the same."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        batched_eigh_leaf_cuda(torch.zeros(2, 150, 150))
    for fn in (batched_eigh_leaf_cuda, batched_eigh_leaf_plain):
        with pytest.raises(TypeError, match="float32"):
            fn(torch.zeros(1, 96, 96, dtype=torch.float64))
        with pytest.raises(ValueError, match=r"\[B, m, m\]"):
            fn(torch.zeros(1, 96, 95))
        with pytest.raises(ValueError, match=r"\[B, m, m\]"):
            fn(torch.zeros(96, 96))
        with pytest.raises(ValueError, match="m <= 160"):
            fn(torch.zeros(1, 161, 161))
        with pytest.raises(ValueError, match="m <= 160"):
            fn(torch.zeros(1, 0, 0))
        with pytest.raises(ValueError, match="at least one sweep"):
            fn(torch.zeros(1, 96, 96), sweeps=0)


def _leaf_route_on_the_cpu(monkeypatch):
    """The route rule as the card takes it, for CPU tensors too: the leaf
    range goes to the plain leaf solve."""
    rule = jacobi.route
    monkeypatch.setattr(jacobi, "route", lambda shape, dtype, device, eager=False: rule(
        shape, dtype, CUDA, eager))


def _ggn_like(n, seed=3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.exp(-np.linspace(0, 11, n)) * 250.0 + 1e-7
    return ((Q * lam) @ Q.T).astype(np.float32)


_jax_eigh = jax.jit(lambda H: jax_eigh_dc(H, return_info=True))
_jax_eigvalsh = jax.jit(lambda H: jax_eigh_dc(H, eigenvectors=False, return_info=True))


@pytest.mark.parametrize("vectors", [False, True], ids=["eigenvalues", "eigenpairs"])
def test_eigh_dc_on_the_leaf_route(monkeypatch, vectors):
    """``eigh_dc`` at n = 384 with the card's route (its leaves and bottom
    block on the plain leaf solve), inside a ``graphs.Segments`` with host
    reads trapped: eigenvalues mode runs as one segment with no eager step,
    eigenvector mode's eager steps are its blocks above 160 alone; the
    result holds against float64 and the JAX package's ``eigh_dc`` at
    BASELINE's bars."""
    n = 384
    A = _ggn_like(n)
    routes = []
    batched = eigdc.batched_eigh

    def noted(B):
        routes.append((tuple(B.shape), jacobi.route(B.shape, B.dtype, B.device)))
        return batched(B)

    _leaf_route_on_the_cpu(monkeypatch)
    monkeypatch.setattr(eigdc, "batched_eigh", noted)
    seg = graphs.Segments()
    _in_segments(monkeypatch, seg)
    _trap_host_reads(monkeypatch, seg)
    ev, V, info = eigdc.eigh_dc(torch.tensor(A), eigenvectors=vectors, return_info=True)
    assert not bool(info["tripped"])
    steps = [tuple(st.args[0].shape) for st in seg.steps]
    assert [s for s, way in routes if way == "vendor"] == steps
    assert any(way == "leaf" for _, way in routes)
    if vectors:
        assert steps and all(s[-1] > LEAF_MAX_M for s in steps)
    else:
        assert steps == []

    ev = ev.numpy().astype(np.float64)
    ref = np.linalg.eigvalsh(A.astype(np.float64))
    _assert_eigenvalues(ev[None], ref[None])
    ev_j, V_j, _ = (_jax_eigh if vectors else _jax_eigvalsh)(jnp.asarray(A))
    _assert_eigenvalues(ev[None], np.asarray(ev_j, np.float64)[None])
    if vectors:
        V, A64, lmax = V.numpy().astype(np.float64), A.astype(np.float64), abs(ev[-1])
        k = 24
        res = np.linalg.norm(A64 @ V[:, -k:] - V[:, -k:] * ev[-k:], axis=0)
        assert np.all(res <= RES_RTOL * lmax + 1e-6), res.max()
        assert np.linalg.norm(V.T @ V - np.eye(n)) / np.sqrt(n) < 1e-4
        top, top_j = V[:, -10:], np.asarray(V_j, np.float64)[:, -10:]
        sign = np.sign(np.sum(top * top_j, axis=0))
        np.testing.assert_allclose(top * sign, top_j, rtol=VEC_RTOL, atol=VEC_ATOL)


@pytest.mark.parametrize("vectors", [False, True], ids=["eigenvalues", "eigenpairs"])
@pytest.mark.parametrize("n", [64, 96, 160])
def test_direct_solve_takes_the_leaf_route(monkeypatch, n, vectors):
    """``eigh_dc``'s direct solve (``n <= 160``) with the card's route,
    inside a ``graphs.Segments`` with host reads trapped: the leaf range is
    the plain leaf solve of ``H[None]``, bit for bit, with no eager step;
    a window size (64) stays the vendor's eager solve, as the JAX
    package's direct solve.  Both hold against float64 at BASELINE's bar."""
    A = _ggn_like(n, seed=n)
    H = torch.tensor(A)
    _leaf_route_on_the_cpu(monkeypatch)
    seg = graphs.Segments()
    _trap_host_reads(monkeypatch, seg)
    ev, V = seg(lambda: eigdc.eigh_dc(H, eigenvectors=vectors))
    steps = [st.fn for st in seg.steps]
    if n == 64:
        assert steps == [torch.linalg.eigh if vectors else torch.linalg.eigvalsh]
    else:
        assert steps == []
        want = [x[0] for x in batched_eigh_leaf_plain(0.5 * (H + H.T)[None])]
        assert torch.equal(ev, want[0])
        assert (V is None) != vectors and (not vectors or torch.equal(V, want[1]))
    _assert_eigenvalues(ev.numpy().astype(np.float64)[None],
                        np.linalg.eigvalsh(A.astype(np.float64))[None])


def test_strip_path_solves_outside_graphs(monkeypatch):
    """The strip path routes its batches as solved outside any graph, so
    that its single blocks of ``m >= 72`` take the vendor on the card; the
    chain path does not."""
    asked = []
    rule = jacobi.route

    def noted(shape, dtype, device, eager=False):
        asked.append((tuple(shape), rule(shape, dtype, CUDA, eager)))
        return rule(shape, dtype, device, eager)

    monkeypatch.setattr(jacobi, "route", noted)
    H = torch.tensor(_ggn_like(384))
    eigdc.eigvalsh_dc(H, strip=256)
    singles = [way for shape, way in asked if shape[0] == 1 and 72 <= shape[-1] <= LEAF_MAX_M]
    assert singles and set(singles) == {"vendor"}
    asked.clear()
    eigdc.eigvalsh_dc(H)
    singles = [way for shape, way in asked if shape[0] == 1 and 72 <= shape[-1] <= LEAF_MAX_M]
    assert singles and set(singles) == {"leaf"}
