"""Spectral divide-and-conquer eigensolver, chain path, eigenvalues mode
(counterpart of ``vivit_tpu/eigdc.py``).

The solver for the symmetric PSD Gram matrices of this library, in full
f32, built from matrix products:

1. **De-skew** ``B = (x + f₃₂(x) + f₁₀₂₄(x))/3`` applied spectrally to
   ``H/s`` by repeated squaring (``f_d(x) = 1−(1−x)^d``): a monotone map that
   spreads GGN spectra spanning ~5 decades.
2. **Count-balanced splits** of ``B``: a Jackson-damped Chebyshev (KPM)
   eigenvalue-count CDF places the split ``σ`` at a low-density point near the
   valid-count median; ``sign(B − σI)`` comes from polar-express
   iterations, and the children are compressed through range-finder panels
   ``orth(P·B·Ω)``.
3. **Ladder**: the bottom half below the first ``σ`` is re-compressed
   against ``H`` (zoom) and re-de-skewed; every level runs ONE batched split
   over all same-size nodes.  The zoom tail merges into the tree, and the
   leaves are solved by :func:`vivit_tpu_torch.kernels.jacobi.batched_eigh`.
4. **Polish** on ``H``: column selection with pad slack, deflation of the
   columns past the valid count, Newton-Schulz re-orthonormalization,
   ``QᵀHQ`` sorted by its diagonal, one sweep of windowed batched Jacobi
   (``w = 32``, the Jacobi kernel), an exact bottom-block solve, and a
   second-order eigenvalue correction.
5. **Guard**: the solver measures its own perturbation bound and basis
   orthonormality; past ``guard`` the eigenvalues come from
   ``torch.linalg.eigvalsh`` instead.  This is the only host read of the
   solve, at its end.

Random draws come from one ``torch.Generator`` on the matrix's device
(seed 0 unless one is given), so results match the JAX package to
tolerance, not bit for bit.  All matmuls run in full f32 (the JAX package's
``HIGHEST`` and ``HIGH``).  The tuning constants are the JAX package's
chain-path defaults (its ``_make_cfg``); the port has one configuration, so
they are module constants.

Not ported yet (``NotImplementedError``): the top-band strip path for
``n ≥ 1536``, eigenvector mode, and ``refine_eigh``.
"""

import math
import warnings
from typing import Optional

import numpy as np
import torch

from vivit_tpu_torch.eig import no_trip_info
from vivit_tpu_torch.kernels.jacobi import batched_eigh
from vivit_tpu_torch.precision import full_f32

# polar-express degree-5 coefficients (slope 3.44 per step)
_PX_A, _PX_B, _PX_C = 3.4445, -4.7750, 2.0315
_F32 = torch.float32
_KPM_GRID = 1024
_SIGMA_FLOOR = 0.04
_MARGIN = 64
_PAD_SLACK = 32
_STRIP_MIN = 1536
# chain path: leaf size, zoom depth cap, (polar-express, Newton-Schulz)
# iterations of the root sign, the other signs and the panel
# orthonormalization, KPM degree
_BASE = 160
_CHAIN = 6
_SIGN_ROOT = (9, 4)
_SIGN = (9, 4)
_ORTH = (8, 3)
_KPM = 64
# eigenvalues-mode polish: global Newton-Schulz steps, window width,
# bottom-block size
_NS_GLOBAL = 3
_WINDOW = 32
_BOTTOM = 96


def _eye(k, like):
    return torch.eye(k, dtype=like.dtype, device=like.device)


def _randn(gen, shape, like):
    return torch.randn(shape, generator=gen, dtype=_F32, device=like.device)


def _t(x):
    return x.transpose(-1, -2)


def _power_norm(A, gen, iters: int = 14):
    """Spectral-norm upper estimate of symmetric ``[..., k, k]`` (×1.05)."""
    v = _randn(gen, A.shape[:-1], A)[..., None]
    v = v / torch.linalg.vector_norm(v, dim=-2, keepdim=True)
    for _ in range(iters):
        w = A @ v
        v = w / (torch.linalg.vector_norm(w, dim=-2, keepdim=True) + 1e-30)
    return torch.linalg.vector_norm(A @ v, dim=(-2, -1)) * 1.05 + 1e-30


def _sign_px(X, iters_px: int, iters_ns: int):
    """Matrix sign of symmetric ``X`` with spectrum in ~[-1, 1]: two
    Newton-Schulz steps (stable for |x| ≤ √3), then polar-express, then
    Newton-Schulz polish."""
    for _ in range(2):
        X = 1.5 * X - 0.5 * ((X @ X) @ X)
    for _ in range(iters_px):
        X2 = X @ X
        X = _PX_A * X + X2 @ (_PX_B * X + _PX_C * (X2 @ X))
    for _ in range(iters_ns):
        X = 1.5 * X - 0.5 * ((X @ X) @ X)
    return X


def _holder_norm(Y):
    """Spectral-norm upper bound √(‖Y‖₁ ‖Y‖∞), shaped to broadcast."""
    c = Y.abs().sum(dim=-2).amax(dim=-1)
    r = Y.abs().sum(dim=-1).amax(dim=-1)
    return (torch.sqrt(c * r) + 1e-30)[..., None, None]


def _orth_px(Y, iters_px: int = 8, iters_ns: int = 3):
    """Panel polar-orthonormalization (tolerates rank deficiency)."""
    Y = Y / _holder_norm(Y)
    for _ in range(iters_px):
        G = _t(Y) @ Y
        Y = _PX_A * Y + Y @ (_PX_B * G + _PX_C * (G @ G))
    for _ in range(iters_ns):
        Y = 1.5 * Y - 0.5 * (Y @ (_t(Y) @ Y))
    return Y


def _deskew(H, s, gen):
    """``(x + f₃₂(x) + f₁₀₂₄(x))/3`` applied spectrally to ``H/s``."""
    I = _eye(H.shape[-1], H)
    s = s[..., None, None]
    # guard shift: f32-noise-negative eigenvalues must not blow up ^1024
    X = (1.02 * I - H / s) / 1.02
    # rescale only on a clear violation, so healthy inputs pass untouched
    nx = _power_norm(X, gen)
    X = X / torch.where(nx > 1.15, nx, torch.ones_like(nx))[..., None, None]
    for _ in range(5):
        X = X @ X  # (1-x)^32
    f32_ = I - X
    for _ in range(5):
        X = X @ X  # (1-x)^1024
    return (H / s + f32_ + (I - X)) / 3.0


def _kpm_cdf(B, gen, degree: int = 64, probes: int = 8):
    """Jackson-damped KPM eigenvalue-count CDF of ``B [b, k, k]`` on
    [-0.05, 1.05]: ``(grid [G], cdf [b, G])``, ``cdf`` monotone."""
    b, k, _ = B.shape
    lo, hi = -0.05, 1.05
    c, h = (hi + lo) / 2.0, (hi - lo) / 2.0 * 1.02
    Z = (torch.randint(0, 2, (b, k, probes), generator=gen, device=B.device)
         .to(_F32) * 2.0 - 1.0)
    T1 = (B @ Z - c * Z) / h
    mus = [(Z * Z).sum(dim=(-2, -1)) / probes, (Z * T1).sum(dim=(-2, -1)) / probes]
    Tm1, T = Z, T1
    for _ in range(degree - 1):
        Tn = 2.0 * (B @ T - c * T) / h - Tm1
        mus.append((Z * Tn).sum(dim=(-2, -1)) / probes)
        Tm1, T = T, Tn
    mu = torch.stack(mus, dim=-1)  # [b, degree+1]

    j = torch.arange(degree + 1, dtype=_F32, device=B.device)
    dpi = math.pi / (degree + 1)
    g = (degree - j + 1) * torch.cos(j * dpi) + torch.sin(j * dpi) / math.tan(dpi)
    mu = mu * g / (degree + 1)

    ts = torch.linspace(-1.0, 1.0, _KPM_GRID, dtype=_F32, device=B.device)
    acos_t = torch.arccos(ts.clamp(-1.0, 1.0))
    jj = torch.arange(1, degree + 1, dtype=_F32, device=B.device)
    terms = torch.sin(jj[:, None] * acos_t[None, :]) / jj[:, None]  # [d, G]
    cdf = mu[:, :1] * (1 - acos_t / math.pi) - (2 / math.pi) * (mu[:, 1:] @ terms)
    cdf = torch.cummax(cdf.clamp(min=0.0), dim=-1).values
    return ts * h + c, cdf


def _pad_slack(n: int) -> int:
    """Extra basis columns carried through the polish."""
    return _PAD_SLACK if n < 2048 else max(_PAD_SLACK, n // 64)


def _margin(k: int) -> int:
    """Capacity slack of a split child: KPM rank error plus noise."""
    return max(int(np.clip(k // 8, 16, _MARGIN)), k // 32)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _split(B, count, gen, sign_iters, kc: int, kpm_degree: int):
    """One batched D&C split of de-skewed nodes ``B [b, k, k]`` with valid
    counts ``count [b]``.

    Returns ``(P, W, PW, r_below)``: the projector below ``σ``, the shared
    range-finder panel ``W = B Ω [b, k, kc]``, ``P W``, and the valid count
    below ``σ``.
    """
    b, k, _ = B.shape
    grid, cdf = _kpm_cdf(B, gen, degree=kpm_degree)
    target = (k - count) + count * 0.5  # [b]
    # σ at the lowest-density point of the rank window around the target: a σ
    # inside a near-degenerate cluster would duplicate it across children
    half_win = (kc - k // 2) * 0.6
    in_window = (cdf - target[:, None]).abs() <= half_win
    density = torch.gradient(cdf, dim=-1)[0]
    inf = torch.full_like(density, float("inf"))
    idx_flat = torch.argmin(torch.where(in_window, density, inf), dim=-1)
    idx_tgt = torch.searchsorted(cdf.contiguous(), target[:, None].contiguous())
    idx_tgt = idx_tgt[:, 0].clamp(1, _KPM_GRID - 1)
    idx = torch.where(in_window.any(dim=-1), idx_flat, idx_tgt)
    sigma_q = grid[idx]
    floored = sigma_q < _SIGMA_FLOOR
    # a floored σ goes to the flattest point just above the floor
    floor_win = (grid >= _SIGMA_FLOOR) & (grid <= 2.5 * _SIGMA_FLOOR)
    floor_sigma = grid[torch.argmin(torch.where(floor_win, density, inf), dim=-1)]
    sigma = torch.where(floored, floor_sigma, sigma_q.clamp(max=0.98))

    I = _eye(k, B)
    Xs = B - sigma[:, None, None] * I
    nrm = _power_norm(Xs, gen)
    U = _sign_px(Xs / nrm[:, None, None], *sign_iters)
    P = 0.5 * (I - U)
    trace = torch.diagonal(P, dim1=-2, dim2=-1).sum(dim=-1)
    r_below = torch.round(trace) - (k - count)

    Om = _randn(gen, (b, k, kc), B) / np.sqrt(k)
    W = B @ Om  # range finder through B: exact nulls never propagate
    PW = P @ W
    return P, W, PW, r_below


def _compress(Y, M):
    C = _t(Y) @ (M @ Y)
    return 0.5 * (C + _t(C))


def _ladder(H, count, gen):
    """Level-synchronous chain basis: ``(Q [n, cols], mask [cols])``.

    Every level runs one batched split over the zoom node (while it lives)
    and all tree nodes of that size.  The zoom descends while its child
    capacity exceeds ``1.5·base``; then it merges into the tree (de-skewed
    when still wider than ``base``).  Levels stop when the node size
    reaches ``base``, and the leaves are solved in one batch
    (:func:`~vivit_tpu_torch.kernels.jacobi.batched_eigh`, as are the polish
    windows).  Counts stay device tensors: the loop's structure depends on
    ``n`` alone.
    """
    n = H.shape[0]
    Hz, lift_z, count_z = H, None, count  # lift None = identity at the root
    TB = TC = TL = None  # tree nodes [b, m, m], counts [b], lifts [b, n, m]
    level, m = 0, n
    while True:
        kc = m // 2 + _margin(m)
        zoom_live = Hz is not None
        if zoom_live:
            Bz = _deskew(Hz, _power_norm(Hz, gen), gen)
            nodes = Bz[None] if TB is None else torch.cat([Bz[None], TB])
            counts_all = (count_z[None] if TC is None
                          else torch.cat([count_z[None], TC]))
        else:
            nodes, counts_all = TB, TC
        bsz = nodes.shape[0]
        sign_it = _SIGN_ROOT if level == 0 else _SIGN
        P, W, PW, r = _split(nodes, counts_all, gen, sign_it, kc, _KPM)

        # panels: the zoom node's bottom is the H-space λ-weighted capture
        if zoom_live:
            Om = _randn(gen, (m, kc), H) / np.sqrt(m)
            Wz = P[0] @ (Hz @ (P[0] @ Om))
            bottoms = torch.cat([Wz[None], PW[1:]])
        else:
            bottoms = PW
        Y = _orth_px(torch.cat([bottoms, W - PW]), *_ORTH)
        Yb, Yt = Y[:bsz], Y[bsz:]

        # compressions: the zoom bottom against Hz, everything else its B
        mats_b = torch.cat([Hz[None], nodes[1:]]) if zoom_live else nodes
        Cb, Ct = _compress(Yb, mats_b), _compress(Yt, nodes)

        if zoom_live:
            r0 = _clip(r[0], (count_z - kc).clamp(min=0), count_z)
            rz_next = r0.clamp(max=kc)
            rest = counts_all[1:]
            rt = _clip(r[1:], (rest - kc).clamp(min=0), rest.clamp(max=kc))
            TC_next = torch.cat([(count_z - r0)[None], rt, rest - rt])
            if lift_z is None:  # root level: the lifts are the panels
                lz_next, lifts_new = Yb[0], Yt[0:1]
            else:
                lz_next, lifts_new = lift_z @ Yb[0], (lift_z @ Yt[0])[None]
            if TL is not None:
                TL_next = torch.cat([lifts_new, TL @ Yb[1:], TL @ Yt[1:]])
                TB_next = torch.cat([Ct[0:1], Cb[1:], Ct[1:]])
            else:
                TL_next, TB_next = lifts_new, Ct[0:1]
        else:
            rt = _clip(r, (counts_all - kc).clamp(min=0),
                       counts_all.clamp(max=kc))
            TC_next = torch.cat([rt, counts_all - rt])
            TL_next = torch.cat([TL @ Yb, TL @ Yt])
            TB_next = torch.cat([Cb, Ct])

        if zoom_live:
            if level + 1 < _CHAIN and kc > int(1.5 * _BASE):
                Hz, lift_z, count_z = Cb[0], lz_next, rz_next
            else:
                # tail merge: hand the last zoom node to the tree, de-skewed
                # by its own top unless the leaf solve takes it directly
                tail = Cb[0]
                if kc > _BASE:
                    tail = _deskew(tail, _power_norm(tail, gen), gen)
                TB_next = torch.cat([TB_next, tail[None]])
                TC_next = torch.cat([TC_next, rz_next[None]])
                TL_next = torch.cat([TL_next, lz_next[None]])
                Hz = lift_z = None
        TB, TC, TL = TB_next, TC_next, TL_next

        m = kc
        level += 1
        if m <= _BASE:
            _, evecs = batched_eigh(TB)  # [b, m, m] ascending
            lifted = TL @ evecs
            pos = torch.arange(m, device=H.device)[None, :]
            masks = pos >= (m - TC[:, None])
            return (lifted.permute(1, 0, 2).reshape(n, -1), masks.reshape(-1))


def _basis(H, count, gen):
    """Approximate eigenbasis of ``H`` (columns) and its validity mask."""
    if H.shape[0] >= _STRIP_MIN:
        raise NotImplementedError(
            f"eigh_dc at n={H.shape[0]} needs the top-band strip path "
            f"(n >= {_STRIP_MIN}), which is not ported yet; use backend='xla'."
        )
    return _ladder(H, count, gen)


def _sort_by_diag(Bt):
    order = torch.argsort(torch.diagonal(Bt))
    return Bt[order][:, order]


def _apply_blockdiag(Bt, V, off: int, hi: int, w: int):
    """Apply ``R = diag(V[0..nb])`` to rows and columns ``[off:hi]`` of
    ``Bt`` (stripe products instead of full n×n matmuls)."""
    n = Bt.shape[0]
    nb = (hi - off) // w
    Bt = Bt.clone()
    rows = Bt[off:hi, :].reshape(nb, w, n)
    Bt[off:hi, :] = torch.einsum("bwk,bwn->bkn", V, rows).reshape(hi - off, n)
    cols = Bt[:, off:hi].reshape(n, nb, w)
    Bt[:, off:hi] = torch.einsum("nbw,bwk->nbk", cols, V).reshape(n, hi - off)
    return Bt


def _windowed_jacobi(Bt, w: int = _WINDOW):
    """Kill near-diagonal couplings: batched eigh of the diagonal windows at
    offsets 0 and ``w/2``."""
    n = Bt.shape[0]
    for off in (0, w // 2):
        hi = off + ((n - off) // w) * w
        if hi <= off:
            continue
        nb = (hi - off) // w
        blocks = Bt[off:hi, off:hi].reshape(nb, w, nb, w)
        subs = torch.diagonal(blocks, dim1=0, dim2=2).permute(2, 0, 1)
        _, V = batched_eigh(subs)  # [nb, w, w]
        Bt = _apply_blockdiag(Bt, V, off, hi, w)
        Bt = 0.5 * (Bt + Bt.T)
    return _sort_by_diag(Bt)


def _bottom_block(Bt, nb: int):
    """Exact solve of the bottom (de-skew-squashed) diagonal block."""
    nb = min(nb, Bt.shape[0])
    if nb <= 0:
        return Bt
    _, V = batched_eigh(Bt[:nb, :nb][None])
    Bt = _apply_blockdiag(Bt, V, 0, nb, nb)
    return 0.5 * (Bt + Bt.T)


def eigh_dc(
    H: torch.Tensor,
    *,
    eigenvectors: bool = True,
    generator: Optional[torch.Generator] = None,
    guard: Optional[float] = 1e-4,
    return_info: bool = False,
):
    """Full spectrum of a symmetric PSD matrix: ``(evals [n] ascending,
    evecs or None[, info])``.

    ``n ≤ 160`` goes straight to ``torch.linalg.eigh``.  Larger ``n`` runs
    the chain path in eigenvalues mode (``eigenvectors=False``);
    ``generator`` (on ``H``'s device) seeds its random draws.

    ``guard``: threshold of the runtime self-check (perturbation bound of the
    remaining couplings, and orthonormality drift of the significant basis
    columns); past it, or on a NaN, the eigenvalues come from
    ``torch.linalg.eigvalsh`` and a warning says so.  ``guard=None`` skips
    the check.  ``return_info`` adds ``{"tripped", "bound", "orth"}``.
    """
    n = H.shape[0]
    with full_f32():
        H = (0.5 * (H + H.T)).to(_F32)
        if n <= max(_BASE, 2 * _MARGIN):
            if eigenvectors:
                evals, evecs = torch.linalg.eigh(H)
            else:
                evals, evecs = torch.linalg.eigvalsh(H), None
            return ((evals, evecs, no_trip_info(H.device)) if return_info
                    else (evals, evecs))
        if eigenvectors:
            raise NotImplementedError(
                "eigh_dc's eigenvector mode is not ported yet; use "
                "eigenvectors=False or backend='xla'."
            )
        if generator is None:
            generator = torch.Generator(device=H.device)
            generator.manual_seed(0)
        return _eigvalsh_chain(H, generator, guard, return_info)


def _eigvalsh_chain(H, gen, guard, return_info):
    n = H.shape[0]
    count = torch.tensor(float(n), dtype=_F32, device=H.device)
    Q, mask = _basis(H, count, gen)

    # Select n + slack columns: the mask dominates, then column norm.  The
    # pad columns collapse to spurious zeros and are dropped at the end.
    colnorm = torch.linalg.vector_norm(Q, dim=0)
    rel = colnorm / (colnorm.max() + 1e-30)
    score = torch.where(mask, 2.0, 0.0) + rel
    m = n + min(_pad_slack(n), Q.shape[1] - n)
    order = torch.topk(score, m).indices
    Q = Q[:, order]

    # deflate the columns past the valid count against the leading ones
    n_valid = torch.clamp(mask[order].sum(), max=n)
    lead = (torch.arange(m, device=H.device) < n_valid).to(_F32)[None, :]
    Qlead, Qtail = Q * lead, Q * (1.0 - lead)
    for _ in range(2):
        Qtail = Qtail - Qlead @ (Qlead.T @ Qtail)
    Q = Qlead + Qtail

    # global re-orthonormalization
    for _ in range(_NS_GLOBAL):
        Q = 1.5 * Q - 0.5 * (Q @ (Q.T @ Q))

    Bt = _compress(Q, H)
    rayleigh0 = torch.diagonal(Bt).clone()  # column-aligned with Q, for guard
    Bt = _sort_by_diag(Bt)
    Bt = _windowed_jacobi(Bt, _WINDOW)
    Bt = _bottom_block(Bt, _BOTTOM)

    # second-order correction Σ_j E_ij²/(d_i − d_j) over well-separated pairs
    d0 = torch.diagonal(Bt)
    E0 = Bt - torch.diag(d0)
    gap0 = d0[:, None] - d0[None, :]
    ok0 = gap0.abs() > 3.0 * E0.abs()
    safe_gap0 = torch.where(gap0 == 0.0, torch.ones_like(gap0), gap0)
    corr = torch.where(ok0, E0 * E0 / safe_gap0, torch.zeros_like(E0))
    d = d0 + corr.sum(dim=1)
    pad = m - n
    evals = torch.sort(d).values[pad:]

    if guard is None:
        return (evals, None, no_trip_info(H.device)) if return_info else (evals, None)

    # defect 1: perturbation bound of the remaining couplings; the pairs the
    # correction handled are third order there
    E = E0
    lmax = d.abs().max() + 1e-30
    I_m = torch.eye(m, dtype=_F32, device=H.device)
    gap = (d[None, :] - d[:, None]).abs() + I_m
    term = torch.minimum(E * E / gap.clamp(min=1e-30), E.abs())
    third = E.abs() * torch.square(E / gap0.abs().clamp(min=1e-30))
    term = torch.where(ok0, torch.minimum(third, E.abs()), term) * (1.0 - I_m)
    bound = term.sum(dim=1).max() / lmax
    # defect 2: orthonormality among the significant basis columns
    sig = (rayleigh0.abs() > 1e-4 * lmax).to(_F32)
    gram_q = (Q.T @ Q - I_m) * (sig[:, None] * sig[None, :])
    orth = torch.linalg.matrix_norm(gram_q) / torch.sqrt(sig.sum() + 1.0)
    bad = (bound > guard) | (orth > guard) | torch.isnan(d).any()
    info = {"tripped": bad, "bound": bound, "orth": orth}
    if bool(bad):  # the solve's one host read
        warnings.warn(
            "eigh_dc runtime guard tripped (perturbation bound "
            f"{float(bound):.2e}, orthonormality {float(orth):.2e}): the "
            "eigenvalues come from torch.linalg.eigvalsh, and this call paid "
            "for both solvers.",
            stacklevel=3,
        )
        evals = torch.linalg.eigvalsh(H)
    return (evals, None, info) if return_info else (evals, None)


def eigvalsh_dc(H: torch.Tensor, *, return_info: bool = False, **kwargs):
    """Eigenvalues-only :func:`eigh_dc`: ``evals`` or ``(evals, info)``."""
    out = eigh_dc(H, eigenvectors=False, return_info=return_info, **kwargs)
    if return_info:
        return out[0], out[2]
    return out[0]


def refine_eigh(*args, **kwargs):
    """Warm-start refinement of an eigenbasis: not ported yet."""
    raise NotImplementedError("refine_eigh is not ported yet.")
