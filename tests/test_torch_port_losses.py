"""Parity of the port's losses with the JAX package's: per-sample values and
reductions, the loss-Hessian square roots (compared through ``SᵀS``: a root
is defined up to a rotation of its rows), Hessian-vector products and the
Monte-Carlo factors, for MSE, cross-entropy and a custom loss.

The JAX package draws its Monte-Carlo factors from ``fold_in(key, id)``,
the port from a per-sample ``torch.Generator``: the streams differ by
design.  So the port's factor function is fed the JAX package's draws,
recovered from its factors, and must reproduce them (≤ 1e-6); the port's
own draws are held to the Hessian in expectation, averaged over keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vivit_tpu as vt
from vivit_tpu.ggn import loss_hessian_sqrt as jax_loss_hessian_sqrt

import vivit_tpu_torch as vtt
from vivit_tpu_torch.ggn import loss_hessian_sqrt
from vivit_tpu_torch.losses import Loss, sample_generator

# f32 elementwise (BASELINE.md): rtol 1e-6 on values, 1e-5 on Hessian
# products; the replayed MC factors within 1e-6
VAL_RTOL, RTOL, ATOL, MC_ATOL = 1e-6, 1e-5, 1e-6, 1e-6
S, C = 5, 4


def _custom(lib):
    """A convex per-sample loss with a non-diagonal Hessian (log-sum-exp
    plus a quadratic), written once for each package."""
    if lib is jnp:
        return lambda f_n, y_n: jax.nn.logsumexp(f_n - y_n) + 0.125 * jnp.sum((f_n - y_n) ** 2)
    return lambda f_n, y_n: torch.logsumexp(f_n - y_n, 0) + 0.125 * ((f_n - y_n) ** 2).sum()


LOSSES = {
    "mse": (lambda r: vt.MSELoss(r), lambda r: vtt.MSELoss(r), False),
    "ce": (lambda r: vt.CrossEntropyLoss(r), lambda r: vtt.CrossEntropyLoss(r), True),
    "custom": (lambda r: vt.CustomLoss(_custom(jnp), r),
               lambda r: vtt.CustomLoss(_custom(torch), r), False),
}
CASES = [(name, r) for name in LOSSES for r in ("mean", "sum")]
IDS = [f"{name}-{r}" for name, r in CASES]


def _inputs(integer, seed=0):
    rng = np.random.default_rng(seed)
    f = (2.0 * rng.normal(size=(S, C))).astype(np.float32)
    y = (rng.integers(0, C, size=(S,)).astype(np.int32) if integer
         else rng.normal(size=(S, C)).astype(np.float32))
    return f, y


def _losses(name, reduction):
    make_jax, make_port, integer = LOSSES[name]
    return make_jax(reduction), make_port(reduction), integer


@pytest.mark.parametrize("name,reduction", CASES, ids=IDS)
def test_values_match(name, reduction):
    jloss, ploss, integer = _losses(name, reduction)
    f, y = _inputs(integer)
    ft, yt = torch.tensor(f), torch.tensor(y)
    np.testing.assert_allclose(ploss.per_sample(ft, yt).numpy(),
                               np.asarray(jloss.per_sample(f, y)), rtol=VAL_RTOL)
    np.testing.assert_allclose(float(ploss(ft, yt)), float(jloss(f, y)), rtol=VAL_RTOL)
    assert ploss.rho(8) == jloss.rho(8)


@pytest.mark.parametrize("name,reduction", CASES, ids=IDS)
def test_sqrt_hessian_gram_matches(name, reduction):
    """``SᵀS`` per sample: the loss Hessian itself."""
    jloss, ploss, integer = _losses(name, reduction)
    f, y = _inputs(integer, seed=1)
    js = np.asarray(jax.vmap(jloss.sqrt_hessian)(jnp.asarray(f), jnp.asarray(y)))
    ps = ploss.sqrt_hessian(torch.tensor(f), torch.tensor(y)).numpy()
    assert ps.shape == js.shape == (S, C, C)
    want = np.einsum("sci,scj->sij", js, js)
    got = np.einsum("sci,scj->sij", ps, ps)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["mse", "ce"])
def test_generic_sqrt_hessian_matches_analytic(name):
    """The base class's eigendecomposition fallback against each loss's
    analytic factor, through ``SᵀS``."""
    _, ploss, integer = _losses(name, "mean")
    f, y = _inputs(integer, seed=2)
    ft, yt = torch.tensor(f), torch.tensor(y)
    analytic = ploss.sqrt_hessian(ft, yt)
    generic = Loss.sqrt_hessian(ploss, ft, yt)
    torch.testing.assert_close(generic.transpose(-1, -2) @ generic,
                               analytic.transpose(-1, -2) @ analytic, rtol=RTOL, atol=ATOL)


def test_generic_sqrt_hessian_warns_for_wide_outputs():
    loss = vtt.CustomLoss(lambda f_n, y_n: 0.5 * (f_n ** 2).sum())
    with pytest.warns(UserWarning, match="O\\(N·C³\\)"):
        loss.sqrt_hessian(torch.zeros(1, 129), torch.zeros(1))


@pytest.mark.parametrize("name,reduction", CASES, ids=IDS)
def test_hessian_vp_matches(name, reduction):
    jloss, ploss, integer = _losses(name, reduction)
    f, y = _inputs(integer, seed=3)
    t = np.random.default_rng(4).normal(size=(S, C)).astype(np.float32)
    want = np.asarray(jloss.hessian_vp(jnp.asarray(f), jnp.asarray(y), jnp.asarray(t)))
    got = ploss.hessian_vp(torch.tensor(f), torch.tensor(y), torch.tensor(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max())
    # the base class's generic jvp-of-grad agrees with the analytic override
    generic = Loss.hessian_vp(ploss, torch.tensor(f), torch.tensor(y), torch.tensor(t))
    np.testing.assert_allclose(generic.numpy(), want, rtol=RTOL, atol=ATOL * np.abs(want).max())


def _jax_mc(jloss, f, y, mc, key):
    return np.asarray(jax_loss_hessian_sqrt(jloss, jnp.asarray(f), jnp.asarray(y),
                                            mc_samples=mc, key=jax.random.PRNGKey(key)))


@pytest.mark.parametrize("name,reduction", [c for c in CASES if c[0] != "custom"],
                         ids=[i for i in IDS if not i.startswith("custom")])
def test_mc_factors_from_jax_draws(name, reduction):
    """The port's factor function on the JAX package's draws gives the JAX
    package's factors: MSE ``ε = s/√(h/M)``, CE ``label = argmax(p − √M·s)``."""
    jloss, ploss, integer = _losses(name, reduction)
    f, y = _inputs(integer, seed=5)
    mc = 6
    js = _jax_mc(jloss, f, y, mc, key=3)
    if name == "mse":
        draws = torch.tensor(js / np.sqrt(jloss._h(C) / mc))
    else:
        p = np.asarray(jax.nn.softmax(jnp.asarray(f), axis=-1))
        draws = torch.tensor(np.argmax(p[:, None, :] - np.sqrt(mc) * js, axis=-1))
    got = ploss.sqrt_hessian_mc(torch.tensor(f), torch.tensor(y), draws).numpy()
    assert got.shape == js.shape == (S, mc, C)
    np.testing.assert_allclose(got, js, rtol=0, atol=MC_ATOL)


@pytest.mark.parametrize("name", ["mse", "ce"])
def test_mc_factors_unbiased_over_keys(name):
    """``E[Σ_m s̃_m s̃_mᵀ]`` over 400 keys × 10 draws against the exact
    Hessian ``SᵀS``: within 5 standard errors of the estimate (logits scaled
    down so that no class is so rare that the sample spread misstates the
    error)."""
    _, ploss, integer = _losses(name, "mean")
    f, y = _inputs(integer, seed=6)
    ft, yt = torch.tensor(f / 4, dtype=torch.float64), torch.tensor(y)
    if not integer:
        yt = yt.double()
    exact = ploss.sqrt_hessian(ft, yt)
    exact = exact.transpose(-1, -2) @ exact
    keys, mc = 400, 10
    samples = torch.stack([
        (lambda s: s.transpose(-1, -2) @ s)(loss_hessian_sqrt(ploss, ft, yt, mc_samples=mc,
                                                              key=k))
        for k in range(keys)])
    mean, sem = samples.mean(0), samples.std(0) / keys ** 0.5
    assert bool(((mean - exact).abs() <= 5 * sem + 1e-12).all())


def test_mc_draws_are_per_key_and_sample_id():
    """Draws depend on (key, global sample id) only: a sample keeps its
    draws in another batch, other keys and ids draw other numbers, and the
    generator seed mixes both."""
    loss = vtt.MSELoss()
    f = torch.zeros(4, C)
    full = loss.mc_draws(f, f, 3, 7, [0, 1, 2, 3])
    part = loss.mc_draws(f[:2], f[:2], 3, 7, [3, 1])
    assert torch.equal(part, full[[3, 1]])
    assert not torch.equal(loss.mc_draws(f, f, 3, 8, [0, 1, 2, 3]), full)
    assert not torch.equal(full[0], full[1])
    a = torch.rand(3, generator=sample_generator(1, 0))
    assert torch.equal(a, torch.rand(3, generator=sample_generator(1, 0)))
    assert not torch.equal(a, torch.rand(3, generator=sample_generator(0, 1)))
    labels = vtt.CrossEntropyLoss().mc_draws(torch.tensor(_inputs(True)[0]), None, 50, 2,
                                             range(S))
    assert labels.shape == (S, 50) and int(labels.min()) >= 0 and int(labels.max()) < C


def test_custom_loss_has_no_mc():
    loss = vtt.CustomLoss(_custom(torch))
    f, y = _inputs(False)
    with pytest.raises(NotImplementedError, match="does not support MC sampling"):
        loss_hessian_sqrt(loss, torch.tensor(f), torch.tensor(y), mc_samples=2, key=0)
    with pytest.raises(ValueError, match="key"):
        loss_hessian_sqrt(vtt.MSELoss(), torch.tensor(f), torch.tensor(y), mc_samples=2)
