"""``eigh_dc``'s configuration surface in the port: the JAX package's
keywords with its defaults, each knob reaching its computation, the forced
guard trip, the int ``key`` of the deflated eigensolvers, and the sweep
tool's configurations.

The defaults passed explicitly are held in
``test_torch_port_eigdc_defaults.py``; the routes the keywords select,
against the JAX package and float64, in ``test_torch_port_eigdc_routes.py``,
``..._deskew.py`` and ``..._sweep_configs.py``, and on a real 3c3d Gram in
``..._3c3d.py``.
"""

import importlib.util
import inspect
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vivit_tpu.deflate import deflated_eigh as jax_deflated_eigh
from vivit_tpu.deflate import deflated_eigvalsh as jax_deflated_eigvalsh
from vivit_tpu.eigdc import _make_cfg as jax_make_cfg
from vivit_tpu.eigdc import eigh_dc as jax_eigh_dc

from vivit_tpu_torch import eigdc
from vivit_tpu_torch.deflate import ce_null_complement, deflate_gram, deflated_eigh, deflated_eigvalsh
from vivit_tpu_torch.eigdc import _make_cfg, eigh_dc, eigvalsh_dc

RTOL, ATOL = 1e-4, 5e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _ggn_like(n):
    return np.exp(-np.linspace(0, 11, n)) * 250.0 + 1e-7


def _assert_close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    tol = ATOL * max(1.0, abs(ref[-1])) + RTOL * np.abs(ref)
    assert (err <= tol).all(), (
        f"{int((err > tol).sum())}/{len(ref)} violations, "
        f"max err/tol {(err / tol).max():.2f}"
    )


H384 = torch.tensor(_spectrum_matrix(_ggn_like(384), seed=1))
H512 = torch.tensor(_spectrum_matrix(_ggn_like(512), seed=2))


@pytest.mark.parametrize("fn", [eigh_dc, eigvalsh_dc], ids=["eigh_dc", "eigvalsh_dc"])
def test_signature_has_every_jax_keyword(fn):
    """Every keyword of the JAX ``eigh_dc`` (``eigenvectors`` aside for
    ``eigvalsh_dc``), keyword-only, with the JAX default; ``key`` is an int
    seed in the port, ``None`` by default in both."""
    want = dict(inspect.signature(jax_eigh_dc).parameters)
    del want["H"]
    if fn is eigvalsh_dc:
        del want["eigenvectors"]
    got = dict(inspect.signature(fn).parameters)
    del got["H"]
    assert list(got) == list(want)
    for name, param in want.items():
        assert got[name].kind is inspect.Parameter.KEYWORD_ONLY, name
        assert got[name].default == param.default, name


def test_make_cfg_has_the_jax_key_set():
    """``_make_cfg`` builds the JAX package's key set with its defaults
    (the precision keys hold the names, where JAX maps them to
    ``lax.Precision``); ``deskew_terms`` is 3 or 4."""
    got, want = _make_cfg(), jax_make_cfg()
    assert list(got) == list(want)
    assert all(got[k] == want[k] for k in want if not k.endswith("_prec"))
    assert _make_cfg(kpm=48)["kpm_tree"] == 48 and _make_cfg(kpm_tree=24)["kpm_tree"] == 24
    with pytest.raises(ValueError, match="deskew_terms"):
        eigvalsh_dc(H384, deskew_terms=5)


def _solver_batches(**kw):
    """The shapes of the batches ``batched_eigh`` receives in one
    ``eigvalsh_dc`` of ``H384`` (or ``eigh_dc`` with ``eigenvectors=True``)."""
    shapes = []
    solve = eigdc.batched_eigh

    def recording(A):
        shapes.append(tuple(A.shape))
        return solve(A)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eigdc, "batched_eigh", recording)
        eigh_dc(H384, **{"eigenvectors": False, **kw})
    return shapes


def test_base_sets_the_leaves():
    """The ladder's levels stop at ``base``: 150-wide leaves under the
    default 160, the top child and the merged zoom tail at 240 under 256."""
    leaves = [s for s in _solver_batches() if s[-1] > 96]
    assert leaves == [(4, 150, 150)]
    leaves = [s for s in _solver_batches(base=256) if s[-1] > 96]
    assert leaves == [(2, 240, 240)]


def test_bottom_and_wj_iters_set_the_polish():
    """``bottom`` sizes the bottom block (96 by default in eigenvalues mode,
    320 in eigenvector mode); ``wj_iters`` counts the windowed sweeps, two
    window batches each (the w=32 windows of the padded 416-wide pencil)."""
    default = _solver_batches()
    assert (1, 96, 96) in default and (1, 64, 64) not in default
    assert (1, 64, 64) in _solver_batches(bottom=64)
    assert (1, 320, 320) in _solver_batches(eigenvectors=True)
    windows = [(13, 32, 32), (12, 32, 32)]
    assert [s for s in default if s[1:] == (32, 32)] == windows
    swept = _solver_batches(wj_iters=(2, 1, 1))
    assert [s for s in swept if s[1:] == (32, 32)] == windows * 4


def test_chain_caps_the_recursion_depth(monkeypatch):
    """On the recursive chain (``ladder=False``) at n=512 the zoom recurses
    once by default (512 → 320 → 200); ``chain=1`` solves the first zoom
    node exactly."""
    depths = []
    basis = eigdc._basis

    def recording(H, count, gen, depth, cfg):
        depths.append(depth)
        return basis(H, count, gen, depth, cfg)

    monkeypatch.setattr(eigdc, "_basis", recording)
    eigvalsh_dc(H512, ladder=False)
    assert depths == [0, 1]
    depths.clear()
    eigvalsh_dc(H512, ladder=False, chain=1)
    assert depths == [0]


MOVES = [
    ("kpm_degree", 48, {}),
    ("kpm_tree", 32, {"ladder": False}),  # the ladder ignores kpm_tree, as in JAX
    ("sign_iters_root", (8, 4), {}),
    ("sign_iters", (8, 4), {}),
    ("orth_iters", (7, 3), {}),
    ("ns_global", 4, {}),
    ("dm_ns", 1, {"eigenvectors": True}),  # eigenvalues mode runs no DM step
]


_DEFAULTS = {}  # the unmoved results, per keyword set


@pytest.mark.parametrize("knob,value,base_kw", MOVES, ids=[m[0] for m in MOVES])
def test_knob_moves_the_output_bits(knob, value, base_kw):
    """Each iteration or degree knob reaches the computation: the output
    moves, and stays within float64's bar."""
    kw = {"eigenvectors": False, **base_kw}
    key = tuple(sorted(kw.items()))
    if key not in _DEFAULTS:
        _DEFAULTS[key] = eigh_dc(H512, **kw)
    default = _DEFAULTS[key]
    moved = eigh_dc(H512, **kw, **{knob: value})
    assert not torch.equal(moved[0], default[0])
    _assert_close(moved[0].numpy(), np.linalg.eigvalsh(H512.double().numpy()))


@pytest.mark.parametrize("vectors", [False, True], ids=["eigenvalues", "eigenpairs"])
def test_forced_trip_falls_back(vectors):
    """The counterpart of ``tests/test_guard_info.py``'s forced trip: at
    N=512 on an 8-fold degenerate spectrum, the degraded keywords trip the
    guard in both modes, and the result is the vendor solver's."""
    A = _spectrum_matrix(np.repeat(np.exp(-np.arange(64) / 10.0), 8), seed=int(vectors))
    H = torch.tensor(A)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ev, V, info = eigh_dc(
            H, eigenvectors=vectors, return_info=True, sign_iters_root=(1, 1),
            sign_iters=(1, 1), orth_iters=(1, 1), ns_global=0, dm_iters=(0, 0, 0),
            kpm_degree=8)
    assert bool(info["tripped"])
    assert float(info["bound"]) > 1e-4 or float(info["orth"]) > 1e-4
    assert any("guard tripped" in str(w.message) for w in caught)
    _assert_close(ev.numpy(), np.linalg.eigvalsh(A.astype(np.float64)))
    sym = 0.5 * (H + H.T)
    if vectors:
        want_ev, want_V = torch.linalg.eigh(sym)
        assert torch.equal(ev, want_ev) and torch.equal(V, want_V)
        assert (V.T @ V - torch.eye(512)).abs().max() < 1e-4
    else:
        assert V is None and torch.equal(ev, torch.linalg.eigvalsh(sym))


def _ce_problem(s=24, c=10, d=300, seed=0):
    """A CE Gram ``[C·S, C·S]`` (index ``c·S + n``) with its ``S``
    structural zeros, and its softmax probabilities ``[S, C]``."""
    rng = np.random.default_rng(seed)
    p = np.exp(rng.normal(size=(s, c)))
    p /= p.sum(axis=1, keepdims=True)
    sqrt_h = np.sqrt(p)[:, :, None] * (np.eye(c)[None] - p[:, None, :])  # row c: √p_c(e_c − p)
    J = rng.normal(size=(s, c, d)) / np.sqrt(d)
    V = np.einsum("nck,nkd->cnd", sqrt_h, J).reshape(c * s, d)
    return (V @ V.T).astype(np.float32), p.astype(np.float32)


@pytest.mark.parametrize("vectors", [False, True], ids=["eigvalsh", "eigh"])
def test_deflated_with_key_matches_jax(vectors):
    """``deflated_eigvalsh``/``deflated_eigh`` take ``key`` and pass it to
    the dc solve of the deflated 216² Gram: equal to the bit to the solve
    with that key, and within the bars of the JAX functions with the same
    key (the two packages draw different numbers from it)."""
    G, p = _ce_problem()
    gram, probs = torch.tensor(G), torch.tensor(p)
    ref = np.linalg.eigvalsh(G.astype(np.float64))
    key = jax.random.PRNGKey(3)
    if vectors:
        ev, V = deflated_eigh(gram, probs, backend="dc", key=3)
        ev_j, V_j = jax.jit(lambda g, q: jax_deflated_eigh(g, q, backend="dc", key=key))(
            jnp.asarray(G), jnp.asarray(p))
        G64, V64, lmax = G.astype(np.float64), V.double().numpy(), abs(ref[-1])
        res = np.linalg.norm(G64 @ V64[:, -24:] - V64[:, -24:] * ev[-24:].double().numpy(), axis=0)
        assert (res <= 5e-4 * lmax + 1e-6).all(), res.max()
        top, top_j = V64[:, -10:], np.asarray(V_j, np.float64)[:, -10:]
        sign = np.sign(np.sum(top * top_j, axis=0))
        np.testing.assert_allclose(top * sign, top_j, rtol=2e-2, atol=2e-3)
        solve = eigh_dc(deflate_gram(gram, ce_null_complement(probs)), key=3)[0]
    else:
        ev = deflated_eigvalsh(gram, probs, backend="dc", key=3)
        ev_j = jax.jit(lambda g, q: jax_deflated_eigvalsh(g, q, backend="dc", key=key))(
            jnp.asarray(G), jnp.asarray(p))
        solve = eigvalsh_dc(deflate_gram(gram, ce_null_complement(probs)), key=3)
        assert not torch.equal(ev, deflated_eigvalsh(gram, probs, backend="dc", key=0))
    assert torch.equal(ev[-len(solve):].sort().values, solve.sort().values)
    _assert_close(ev.numpy(), ref)
    _assert_close(ev.numpy(), np.asarray(ev_j))


def _load(path):
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sweep_tool_runs_the_jax_tools_configs():
    """``tools/torch_sweep_eigdc.py`` runs the configurations of
    ``tools/sweep_eigdc.py``, each a keyword set the port's ``eigh_dc``
    takes."""
    port = _load(os.path.join(ROOT, "tools", "torch_sweep_eigdc.py"))
    ref = _load(os.path.join(ROOT, "tools", "sweep_eigdc.py"))
    assert port.CONFIGS == ref.CONFIGS
    params = inspect.signature(eigvalsh_dc).parameters
    assert all(k in params for kw in port.CONFIGS.values() for k in kw)
