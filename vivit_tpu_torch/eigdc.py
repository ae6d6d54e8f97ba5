"""Spectral divide-and-conquer eigensolver (counterpart of
``vivit_tpu/eigdc.py``).

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
3. **Basis**, by size (with the default keywords):

   * ``n < 1536``, the chain path (:func:`_ladder`): the bottom half below
     the first ``σ`` is re-compressed against ``H`` (zoom) and re-de-skewed;
     every level runs ONE batched split over all same-size nodes.  In
     eigenvalues mode the zoom tail merges into the tree; in eigenvector
     mode it gets an exact eigh (the merge couples the tail's vectors to
     far-away columns).
   * ``n ≥ 1536``, the strip path (:func:`_strip_basis`): a sparse top band
     is split off at a KPM-certified low-density ``σ`` and solved as a
     balanced tree (:func:`_tree`); the bulk is projected exactly
     (``P H P``, full size) and solved by the recursive zoom chain
     (:func:`_basis`), which rescales by its own top at every link.

   Leaves, edge blocks and the polish windows are solved by
   :func:`vivit_tpu_torch.kernels.jacobi.batched_eigh`: on the card the
   Jacobi kernels up to m = 160, ``torch.linalg.eigh`` above.
4. **Polish** on ``H``: column selection with pad slack, deflation of the
   columns past the valid count, Newton-Schulz re-orthonormalization,
   ``QᵀHQ`` sorted by its diagonal, then per mode and path: Davies-Modi
   iterations (:func:`_dm_iteration`), windowed batched Jacobi sweeps
   (``w = 32``, or 64 from ``m = 2048``; the Jacobi kernel where the
   window batch fits it), an exact bottom-block solve and, from
   ``m = 1536``, an exact top-block solve.  Eigenvector mode carries the
   basis ``Q`` through every rotation; eigenvalues mode skips it and adds a
   second-order eigenvalue correction instead.
5. **Guard**: the solver measures its own perturbation bound and basis
   orthonormality; past ``guard`` the result comes from
   ``torch.linalg.eigh``/``eigvalsh`` instead.  This is the only host read
   of the solve, at its end, after the device work.

On a CUDA tensor the chain path (no strip) runs as CUDA graphs, the port's
counterpart of the JAX package's compiled program: the first call per
shape and configuration captures the device work (:func:`_solve`), every
later call replays it (:func:`vivit_tpu_torch.utils.graphs.run`).  Every
leaf and edge block up to m = 160 goes to a Jacobi kernel inside the
graphs.  A larger one goes to the vendor's solve (``torch.linalg.eigh``,
which reads cuSOLVER's status on the host), which runs eagerly between
two graphs.  At n = 1152 with the default knobs the eigenvalues-mode
solve is one graph with no eager step, and the eigenvector-mode solve
has two, its zoom tail ``[1,240,240]`` and bottom block ``[1,320,320]``.
The guard's read, its warning and its fallback run after the last graph.
The strip path and a CPU tensor run eagerly; on the strip path a single
block of m ≥ 72 goes to the vendor, faster alone (:func:`_solve_strip`).
Inside an entry point's captured call
(:func:`vivit_tpu_torch.utils.graphs.stage`) the solve is part of the
call's body: it opens no graphs of its own, and its guard hands its verdict
to the call, which reads it after the replay (:func:`_deferred`).

Random draws come from one ``torch.Generator`` on the matrix's device
(seed 0 unless one is given), so results match the JAX package to
tolerance, not bit for bit.  All matmuls run in full f32, including those
the JAX package demotes to ``HIGH`` on the strip path or under a precision
knob.  :func:`eigh_dc` takes every tuning knob of the JAX package's, with
its defaults, and resolves the unset ones per mode and path as it does:
the basis knobs into one dict (:func:`_make_cfg`, the JAX key set), the
polish knobs into another (:func:`_polish`).  Besides the two default
bases, the knobs reach the recursive chain (``ladder=False``) and the
pre-strip "deep-map" root (``strip=0``), whose de-skew takes a fourth
term at ``n ≥ 2048``.
"""

import functools
import inspect
import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from vivit_tpu_torch.eig import no_trip_info
from vivit_tpu_torch.kernels import jacobi
from vivit_tpu_torch.kernels.jacobi import batched_eigh
from vivit_tpu_torch.precision import full_f32
from vivit_tpu_torch.utils import graphs

# polar-express degree-5 coefficients (slope 3.44 per step)
_PX_A, _PX_B, _PX_C = 3.4445, -4.7750, 2.0315
_F32 = torch.float32
_KPM_GRID = 1024
_SIGMA_FLOOR = 0.04
_MARGIN = 64
_PAD_SLACK = 32
_STRIP_MIN = 1536
# the JAX package's precision names; the port runs every one in full f32
_PRECISIONS = (None, "highest", "high")


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


def _deskew(H, s, gen, terms: int = 3):
    """``(x + f₃₂(x) + f₁₀₂₄(x))/3`` applied spectrally to ``H/s``; with
    ``terms=4``, ``(x + f₃₂ + f₁₀₂₄ + f₃₂₇₆₈)/4`` (five more squarings),
    which lowers the resolvable floor from ~1.1e-4·λmax to ~4.7e-6·λmax.
    Four terms only at the root: a zoom link's compression noise, ~3e-3 of
    its band top, overflows f32 in ``(1+3e-3)^32768``."""
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
    if terms == 3:
        return (H / s + f32_ + (I - X)) / 3.0
    f1024 = I - X
    for _ in range(5):
        X = X @ X  # (1-x)^32768
    return (H / s + f32_ + f1024 + (I - X)) / 4.0


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


def _leaf_masks(k: int, counts):
    """Validity of the ascending columns of ``[b]`` leaves of size ``k``:
    the largest ``count`` of each."""
    return torch.arange(k, device=counts.device)[None, :] >= (k - counts[:, None])


def _ladder(H, count, gen, cfg):
    """Level-synchronous chain basis: ``(Q [n, cols], mask [cols])``.

    Every level runs one batched split over the zoom node (while it lives)
    and all tree nodes of that size, each with ``cfg["kpm"]`` (the JAX
    package's ladder ignores ``kpm_tree``).  The root is de-skewed with
    ``cfg["deskew_terms"]`` terms (3 when unset), every later node with 3.
    The zoom descends while its level is below ``chain`` and its child
    capacity exceeds ``1.5·base``.  Then, with ``tail_merge``, it joins the
    tree (de-skewed when still wider than ``base``); without, it is solved
    by one exact eigh.  Levels stop when the node size reaches ``base``, and
    the leaves are solved in one batch.  Counts stay device tensors: the
    loop's structure depends on ``n`` and ``cfg`` alone.
    """
    n, base = H.shape[0], cfg["base"]
    Hz, lift_z, count_z = H, None, count  # lift None = identity at the root
    TB = TC = TL = None  # tree nodes [b, m, m], counts [b], lifts [b, n, m]
    q_parts, m_parts = [], []
    level, m = 0, n
    while True:
        kc = m // 2 + _margin(m)
        zoom_live = Hz is not None
        if zoom_live:
            terms = (cfg["deskew_terms"] or 3) if level == 0 else 3
            Bz = _deskew(Hz, _power_norm(Hz, gen), gen, terms)
            nodes = Bz[None] if TB is None else torch.cat([Bz[None], TB])
            counts_all = (count_z[None] if TC is None
                          else torch.cat([count_z[None], TC]))
        else:
            nodes, counts_all = TB, TC
        bsz = nodes.shape[0]
        sign_it = cfg["sign_root"] if level == 0 else cfg["sign"]
        P, W, PW, r = _split(nodes, counts_all, gen, sign_it, kc, cfg["kpm"])

        # panels: the zoom node's bottom is the H-space λ-weighted capture
        if zoom_live:
            Om = _randn(gen, (m, kc), H) / np.sqrt(m)
            Wz = P[0] @ (Hz @ (P[0] @ Om))
            bottoms = torch.cat([Wz[None], PW[1:]])
        else:
            bottoms = PW
        Y = _orth_px(torch.cat([bottoms, W - PW]), *cfg["orth"])
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
            if level + 1 < cfg["chain"] and kc > int(1.5 * base):
                Hz, lift_z, count_z = Cb[0], lz_next, rz_next
            elif cfg["tail_merge"]:
                # hand the last zoom node to the tree, de-skewed by its own
                # top unless the leaf solve takes it directly
                tail = Cb[0]
                if kc > base:
                    tail = _deskew(tail, _power_norm(tail, gen), gen)
                TB_next = torch.cat([TB_next, tail[None]])
                TC_next = torch.cat([TC_next, rz_next[None]])
                TL_next = torch.cat([TL_next, lz_next[None]])
                Hz = lift_z = None
            else:
                _, Vz = batched_eigh(Cb[0][None])
                q_parts.append(lz_next @ Vz[0])
                m_parts.append(_leaf_masks(kc, rz_next[None])[0])
                Hz = lift_z = None
        TB, TC, TL = TB_next, TC_next, TL_next

        m = kc
        level += 1
        if m <= base:
            _, evecs = batched_eigh(TB)  # [b, m, m] ascending
            lifted = TL @ evecs
            q_parts.append(lifted.permute(1, 0, 2).reshape(n, -1))
            m_parts.append(_leaf_masks(m, TC).reshape(-1))
            return torch.cat(q_parts, dim=1), torch.cat(m_parts)


def _tree(B, counts, lifts, gen, cfg):
    """Balanced level-batched D&C on de-skewed nodes (no zooms inside).

    ``B [b, k, k]`` nodes with valid counts ``counts [b]`` and isometries
    ``lifts [b, n0, k]`` from the subtree root space.  Every level splits all
    nodes in one batch (``cfg``'s ``sign``, ``orth`` and ``kpm_tree``) until
    they fit ``base``.  Returns ``(masks [L, kb], Q [L, n0, kb])``: the
    leaves' validity and lifted eigenvectors (ascending per leaf).
    """
    k = B.shape[-1]
    while k > cfg["base"]:
        kc = k // 2 + _margin(k)
        bsz = B.shape[0]
        P, W, PW, r = _split(B, counts, gen, cfg["sign"], kc, cfg["kpm_tree"])
        r = _clip(r, (counts - kc).clamp(min=0), counts.clamp(max=kc))
        Y = _orth_px(torch.cat([PW, W - PW]), *cfg["orth"])
        Ym, Yp = Y[:bsz], Y[bsz:]
        B = torch.cat([_compress(Ym, B), _compress(Yp, B)])
        counts = torch.cat([r, counts - r])
        lifts = torch.cat([lifts @ Ym, lifts @ Yp])
        k = kc
    _, evecs = batched_eigh(B)
    return _leaf_masks(k, counts), lifts @ evecs


def _flat_leaves(masks, Q):
    """``_tree`` leaves as basis columns: ``(Q [n0, L·kb], mask [L·kb])``."""
    return Q.permute(1, 0, 2).reshape(Q.shape[1], -1), masks.reshape(-1)


def _basis(H, count, gen, depth: int, cfg):
    """Approximate eigenbasis of ``H`` and its validity: ``(Q [n, cols],
    mask [cols])``.

    At the root (``depth == 0``) the gates of the JAX package's ``_basis``
    choose: the strip (:func:`_strip_basis`) when ``strip != 0`` and
    ``n ≥ (strip or 1536)``; else the ladder (:func:`_ladder`) when
    ``ladder`` and ``n < 2048`` or ``deskew_terms`` is set; else this
    recursion, the "deep map", whose root de-skew takes ``deskew_terms``
    terms, 4 when unset at ``n ≥ 2048``.  Below the root it is the zoom
    chain of the strip's bulk and of the deep map.

    The recursion: de-skew, one split, a λ-weighted capture of the bottom
    re-compressed against ``H`` (recursed into while ``depth + 1 < chain``
    and its capacity exceeds ``1.5·base``, else solved exactly), and a
    balanced tree on the top.
    """
    n = H.shape[0]
    if depth == 0 and cfg["strip"] != 0 and n >= (cfg["strip"] or _STRIP_MIN):
        return _strip_basis(H, count, gen, cfg)
    if cfg["ladder"] and depth == 0 and (n < 2048 or cfg["deskew_terms"] is not None):
        return _ladder(H, count, gen, cfg)
    terms = 3 if depth > 0 else cfg["deskew_terms"] or (4 if n >= 2048 else 3)
    B = _deskew(H, _power_norm(H, gen), gen, terms)
    sign = cfg["sign_root"] if depth == 0 else cfg["sign"]
    kc = n // 2 + _margin(n)
    P, W, PW, r = (x[0] for x in _split(B[None], count[None], gen, sign, kc, cfg["kpm"]))
    r = _clip(r, (count - kc).clamp(min=0), count)
    r_z = r.clamp(max=kc)  # zoom capacity clip (drops the sub-atol tail)

    # bottom: λ-weighted capture (one H application) and the zoom
    Om = _randn(gen, (n, kc), H) / np.sqrt(n)
    Yz = _orth_px(P @ (H @ (P @ Om)), *cfg["orth"])
    Hz = _compress(Yz, H)
    if depth + 1 < cfg["chain"] and kc > int(1.5 * cfg["base"]):
        Qz, mz = _basis(Hz, r_z, gen, depth + 1, cfg)
        Qz = Yz @ Qz
    else:
        _, Vz = batched_eigh(Hz[None])
        Qz, mz = Yz @ Vz[0], _leaf_masks(kc, r_z[None])[0]

    # top: balanced subtree on the de-skewed complement
    Yp = _orth_px(W - PW, *cfg["orth"])
    Qt, mt = _flat_leaves(*_tree(_compress(Yp, B)[None], (count - r)[None],
                                 Yp[None], gen, cfg))
    return torch.cat([Qz, Qt], dim=1), torch.cat([mz, mt])


def _strip_basis(H, count, gen, cfg):
    """Root-level top-band strip for ``n ≥ (strip or 1536)``: ``(Q, mask)``.

    On a large GGN Gram most of the spectrum sits in a narrow band far below
    ``λmax``, where gaps relative to the node's top are near f32 epsilon and
    every split mixes directions, whatever the de-skew map.  An exact
    rescale restores the ratio: strip the sparse top ~6% at a KPM-certified
    low-density ``σ`` (its own balanced tree), project the bulk exactly
    (``H₁ = P H P``, full size) and recurse into it (:func:`_basis`), which
    renormalizes by ``H₁``'s own top.
    """
    n = H.shape[0]
    B = _deskew(H, _power_norm(H, gen), gen)
    grid, cdf = _kpm_cdf(B[None], gen, degree=cfg["kpm"])
    cdf = cdf[0]
    kt = n // 8 + _margin(n // 8)  # static top-child capacity
    target = count - n / 16.0 + (n - count)  # CDF rank below the strip
    win = (kt - n / 16.0) * 0.6
    density = torch.gradient(cdf)[0]
    in_window = (cdf - target).abs() <= win
    idx_flat = torch.argmin(torch.where(in_window, density,
                                        torch.full_like(density, float("inf"))))
    idx_tgt = torch.searchsorted(cdf, target[None])[0].clamp(1, _KPM_GRID - 1)
    idx = torch.where(in_window.any(), idx_flat, idx_tgt)
    sigma = grid[idx].clamp(_SIGMA_FLOOR, 0.98)

    I = _eye(n, H)
    Xs = B - sigma * I
    P = 0.5 * (I - _sign_px(Xs / _power_norm(Xs, gen), *cfg["sign_root"]))
    r = torch.round(torch.trace(P)) - (n - count)  # valid count below σ
    r = _clip(r, count - kt + _margin(kt) // 2, count)

    # top child: de-skewed subtree on the complement (skinny panel)
    W = B @ (_randn(gen, (n, kt), H) / np.sqrt(n))
    Yp = _orth_px(W - P @ W, *cfg["orth"])
    Qt, mt = _flat_leaves(*_tree(_compress(Yp, B)[None], (count - r)[None],
                                 Yp[None], gen, cfg))

    # bulk child: exact full-size spectral projection, renormalized by its
    # own top inside the recursion
    H1 = P @ (H @ P)
    Qz, mz = _basis(0.5 * (H1 + H1.T), r, gen, 1, cfg)
    return torch.cat([Qz, Qt], dim=1), torch.cat([mz, mt])


def _dm_iteration(Bt, Q, ns_iters: int, cap: float = 0.45, guard: float = 3.0):
    """One Davies-Modi step: rotate ``Bt`` (and the basis ``Q``, when
    carried) by the orthonormalized ``I + X``, ``X = E/(dⱼ−dᵢ)`` over the
    well-separated pairs, spectral-norm capped at ``cap``."""
    d = torch.diagonal(Bt)
    E = Bt - torch.diag(d)
    gap = d[None, :] - d[:, None]
    ok = gap.abs() > guard * E.abs()
    X = torch.where(ok, E / torch.where(gap == 0, 1.0, gap), 0.0)
    X = 0.5 * (X - X.T)
    X = X * torch.clamp(cap / (_holder_norm(X) + 1e-30), max=1.0)
    Y = _eye(Bt.shape[0], Bt) + X
    for _ in range(ns_iters):
        Y = 1.5 * Y - 0.5 * (Y @ (Y.T @ Y))
    return _compress(Y, Bt), (Q @ Y if Q is not None else None)


def _sort_by_diag(Bt, Q):
    order = torch.argsort(torch.diagonal(Bt))
    return Bt[order][:, order], (Q[:, order] if Q is not None else None)


def _apply_blockdiag(Bt, Q, V, off: int, hi: int, w: int):
    """Apply ``R = diag(V[0..nb])`` to rows and columns ``[off:hi]`` of
    ``Bt``, and to columns ``[off:hi]`` of ``Q`` (``[rows, m]``, rectangular
    with the pad columns) when carried: stripe products instead of full
    n×n matmuls."""
    n = Bt.shape[0]
    nb = (hi - off) // w
    Bt = Bt.clone()
    rows = Bt[off:hi, :].reshape(nb, w, n)
    Bt[off:hi, :] = torch.einsum("bwk,bwn->bkn", V, rows).reshape(hi - off, n)
    cols = Bt[:, off:hi].reshape(n, nb, w)
    Bt[:, off:hi] = torch.einsum("nbw,bwk->nbk", cols, V).reshape(n, hi - off)
    if Q is not None:
        Q = Q.clone()
        qc = Q[:, off:hi].reshape(Q.shape[0], nb, w)
        Q[:, off:hi] = torch.einsum("nbw,bwk->nbk", qc, V).reshape(Q.shape[0], hi - off)
    return Bt, Q


def _windowed_jacobi(Bt, Q, w: int = 32):
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
        Bt, Q = _apply_blockdiag(Bt, Q, V, off, hi, w)
        Bt = 0.5 * (Bt + Bt.T)
    return _sort_by_diag(Bt, Q)


def _edge_block(Bt, Q, nb: int, top: bool):
    """Exact solve of the bottom (de-skew-squashed) or top (widest relative
    range, slowest to converge) ``nb × nb`` diagonal block."""
    n = Bt.shape[0]
    nb = min(nb, n)
    if nb <= 0:
        return Bt, Q
    off = n - nb if top else 0
    _, V = batched_eigh(Bt[off:off + nb, off:off + nb][None])
    Bt, Q = _apply_blockdiag(Bt, Q, V, off, off + nb, nb)
    return 0.5 * (Bt + Bt.T), Q


def _make_cfg(base=160, chain=6, sign_root=(9, 4), sign=(9, 4), orth=(8, 3),
              kpm=64, basis_prec=None, q_prec=None, deskew_prec=None,
              deskew_terms=None, strip=None, kpm_tree=None, ladder=True,
              tail_merge=True) -> dict:
    """The basis knobs as one dict, with the JAX package's ``_make_cfg``
    keys: leaf size, zoom depth cap, (polar-express, Newton-Schulz)
    iterations of the root sign, the other signs and the panel
    orthonormalization, KPM degree (``kpm_tree`` for the subtree splits,
    ``kpm`` when unset), de-skew terms at the root, strip threshold, the
    ladder and its tail merge.  The precision knobs must be one of
    ``None``, ``"highest"`` and ``"high"``; every matmul runs in full f32
    whatever they say."""
    for name, prec in (("basis_prec", basis_prec), ("q_prec", q_prec),
                       ("deskew_prec", deskew_prec)):
        if prec not in _PRECISIONS:
            raise ValueError(f"{name} must be None, 'highest' or 'high', got {prec!r}")
    if deskew_terms not in (None, 3, 4):
        raise ValueError(f"deskew_terms must be None, 3 or 4, got {deskew_terms!r}")
    return {"base": base, "chain": chain, "sign_root": tuple(sign_root),
            "sign": tuple(sign), "orth": tuple(orth), "kpm": kpm,
            "basis_prec": basis_prec, "q_prec": q_prec, "deskew_prec": deskew_prec,
            "deskew_terms": deskew_terms, "strip": strip, "kpm_tree": kpm_tree or kpm,
            "ladder": ladder, "tail_merge": tail_merge}


def _polish(eigenvectors: bool, strip_on: bool, dm_iters, ns_global, bottom,
            wj_iters, dm_ns) -> dict:
    """The polish knobs, each unset one at the JAX package's default for the
    mode and path: Davies-Modi iterations before/between/after the windowed
    sweeps, global Newton-Schulz steps, edge-block size, windowed sweeps, and
    Newton-Schulz steps per Davies-Modi rotation."""
    if eigenvectors:
        default = {"dm": (2, 1, 1) if strip_on else (2, 2, 1),
                   "ns": 5 if strip_on else 6, "edge": 320, "wj": (1, 1, 1),
                   "dm_ns": 1 if strip_on else 2}
    else:
        default = {"dm": (0, 0, 0), "ns": 3, "edge": 160 if strip_on else 96,
                   "wj": (1, 0, 1) if strip_on else (1, 0, 0), "dm_ns": 1}
    given = {"dm": dm_iters, "ns": ns_global, "edge": bottom, "wj": wj_iters,
             "dm_ns": dm_ns}
    return {k: v if given[k] is None else given[k] for k, v in default.items()}


def eigh_dc(
    H: torch.Tensor,
    *,
    base: int = 160,
    chain: int = 6,
    eigenvectors: bool = True,
    dm_iters: Optional[Tuple[int, int, int]] = None,
    bottom: Optional[int] = None,
    key: Optional[int] = None,
    guard: Optional[float] = 1e-4,
    return_info: bool = False,
    sign_iters_root: Tuple[int, int] = (9, 4),
    sign_iters: Tuple[int, int] = (9, 4),
    orth_iters: Tuple[int, int] = (8, 3),
    kpm_degree: int = 64,
    basis_prec: Optional[str] = None,
    q_prec: Optional[str] = None,
    deskew_prec: Optional[str] = None,
    ns_global: Optional[int] = None,
    dm_ns: Optional[int] = None,
    deskew_terms: Optional[int] = None,
    strip: Optional[int] = None,
    wj_iters: Optional[Tuple[int, int, int]] = None,
    kpm_tree: Optional[int] = None,
    ladder: bool = True,
    tail_merge: Optional[bool] = None,
):
    """Full spectrum of a symmetric PSD matrix: ``(evals [n] ascending,
    evecs [n, n] or None[, info])``.

    ``n ≤ max(base, 128)`` is solved directly: where
    :func:`vivit_tpu_torch.kernels.jacobi.route` gives the leaf kernel (a
    CUDA tensor of ``n ≤ 160`` but 32, 48 and 64), by that kernel, captured
    with the rest of a body; else by ``torch.linalg.eigh`` (``eigvalsh``
    for eigenvalues) as an eager step.  The
    keywords are the JAX package's, with its defaults, and select the same
    computations:

    * ``strip``: the strip threshold (``None``: 1536; ``0``: no strip).  On
      the strip, leaves widen to ``max(base, 320, n // 9)``.
    * ``ladder``: below the strip, the level-synchronous chain (default) or,
      with ``False``, the recursive one, which is also the root at
      ``n ≥ 2048`` without the strip unless ``deskew_terms`` is set.
    * ``deskew_terms``: 3 or 4 terms of the root's de-skew (``None``: 3 on
      the ladder, 4 on the deep map at ``n ≥ 2048``).
    * ``tail_merge``: the ladder's zoom tail joins the tree (``None``: in
      eigenvalues mode only) or gets an exact eigh.
    * ``base``, ``chain``, ``sign_iters_root``, ``sign_iters``,
      ``orth_iters``, ``kpm_degree``, ``kpm_tree``: leaf size, zoom depth
      cap, iterations and KPM degrees of the basis.
    * ``dm_iters``, ``ns_global``, ``bottom``, ``wj_iters``, ``dm_ns``: the
      polish (``None``: the mode's and path's default), ``bottom`` sizing
      the bottom block and, at ``m ≥ 1536``, the top block.
    * ``basis_prec``, ``q_prec``, ``deskew_prec``: ``None``, ``"highest"``
      or ``"high"``, anything else raises.  By the port's precision mapping
      ``"high"`` (the TPU's bf16_3x) runs in full f32, so a demotion the JAX
      package makes gives the port's ``"highest"`` result.

    The random draws come from a generator on ``H``'s device seeded with the
    int ``key`` (default 0).  On a CUDA tensor below the strip the first
    call per ``n``, mode and resolved knobs captures the solve as CUDA
    graphs and later calls replay them, with any ``key`` and ``guard``;
    :func:`vivit_tpu_torch.utils.graphs.clear` drops them.  Inside a
    captured entry point's body the solve runs inline and its guard is read
    after the call's replay.

    ``guard``: threshold of the runtime self-check (perturbation bound of the
    remaining couplings, and orthonormality drift of the significant basis
    columns, or of the eigenvectors in eigenvector mode); past it, or on a
    NaN, the result comes from ``torch.linalg.eigh`` (``eigvalsh``) and a
    warning says so.  ``guard=None`` skips the check.  ``return_info`` adds
    ``{"tripped", "bound", "orth"}``.
    """
    n = H.shape[0]
    with full_f32():
        H = (0.5 * (H + H.T)).to(_F32)
        if n <= max(base, 2 * _MARGIN):
            # the leaf kernel on the card, which a captured body keeps
            # whole; else, the window sizes included, the vendor's solve,
            # as the JAX package's direct solve
            if jacobi.route((1, n, n), H.dtype, H.device) == "leaf":
                evals, evecs = (x[0] for x in batched_eigh(H[None]))
                evecs = evecs if eigenvectors else None
            elif eigenvectors:
                evals, evecs = graphs.eager(torch.linalg.eigh, H)
            else:
                evals, evecs = graphs.eager(torch.linalg.eigvalsh, H), None
            return ((evals, evecs, no_trip_info(H.device)) if return_info
                    else (evals, evecs))
        strip_on = strip != 0 and n >= (strip or _STRIP_MIN)
        if strip_on:
            # the strip's chain must end in wide exact leaves, or a zoom
            # link's capacity clip loses the band's smallest carriers; the
            # JAX package's measured strip precisions (no-ops here)
            base = max(base, 320, n // 9)
            if deskew_prec is None:
                deskew_prec = "high"
            if basis_prec is None:
                basis_prec = "high"
                if q_prec is None:
                    q_prec = "highest"
        polish = _polish(eigenvectors, strip_on, dm_iters, ns_global, bottom,
                         wj_iters, dm_ns)
        # the zoom tail merges into the tree for eigenvalues only: its
        # couplings to far-away columns are second order in the values but
        # first order in the vectors
        cfg = _make_cfg(
            base=base, chain=chain, sign_root=sign_iters_root, sign=sign_iters,
            orth=orth_iters, kpm=kpm_degree, basis_prec=basis_prec, q_prec=q_prec,
            deskew_prec=deskew_prec, deskew_terms=deskew_terms, strip=strip,
            kpm_tree=kpm_tree, ladder=ladder,
            tail_merge=not eigenvectors if tail_merge is None else tail_merge)
        if strip_on:
            solve = _solve_strip
        else:
            solve = _solve_captured if H.is_cuda else _solve_eager
        out = solve(H, 0 if key is None else key, cfg, polish, eigenvectors,
                    guard is not None)
        if graphs.deferring():
            return _deferred(H, *out, guard, return_info)
        return _guarded(H, *out, eigenvectors, guard, return_info)


def _solve_eager(H, seed, cfg, polish, eigenvectors, guarded):
    """:func:`_solve` run eagerly, its draws from a generator on ``H``'s
    device seeded with ``seed``."""
    return _solve(graphs.generator(H.device, seed), H, cfg, polish, eigenvectors, guarded)


def _solve_strip(H, seed, cfg, polish, eigenvectors, guarded):
    """:func:`_solve_eager` on the strip path, which no graph captures: its
    single matrices that the vendor solves faster alone go there
    (:func:`vivit_tpu_torch.kernels.jacobi.outside_graphs`)."""
    with jacobi.outside_graphs():
        return _solve_eager(H, seed, cfg, polish, eigenvectors, guarded)


def _solve_captured(H, seed, cfg, polish, eigenvectors, guarded):
    """:func:`_solve` replayed from CUDA graphs, captured on the first call
    per key (:func:`vivit_tpu_torch.utils.graphs.run`).  The key holds what
    shapes the solve: ``n``, the device, the mode, the resolved basis and
    polish knobs and whether the guard's quantities are computed; not the
    seed, nor the guard's threshold, which is compared after the replay."""
    key = ("eigh_dc", H.shape[0], H.device, eigenvectors, tuple(sorted(cfg.items())),
           tuple(sorted(polish.items())), guarded)
    return graphs.run(key, functools.partial(
        _solve, cfg=cfg, polish=polish, eigenvectors=eigenvectors, guarded=guarded),
        (H,), seed)


def _solve(gen, H, cfg, polish, eigenvectors, guarded):
    """The solve's device work, no host read: ``(evals, evecs or None,
    bound, orth, nan)``, the last three the guard's (``None`` unless
    ``guarded``)."""
    n = H.shape[0]
    count = torch.full((), float(n), dtype=_F32, device=H.device)
    Q, mask = _basis(H, count, gen, 0, cfg)

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
    for _ in range(polish["ns"]):
        Q = 1.5 * Q - 0.5 * (Q @ (Q.T @ Q))

    Bt = _compress(Q, H)
    rayleigh0 = torch.diagonal(Bt).clone()  # column-aligned with Q, for guard
    # eigenvalues mode rotates Bt alone: Q is needed only to return vectors
    Bt, Qp = _sort_by_diag(Bt, Q if eigenvectors else None)
    # windows widen once the relative spacing falls under the couplings
    w = 64 if m >= 2048 else 32
    dm, wj, dm_ns = polish["dm"], polish["wj"], polish["dm_ns"]
    for _ in range(dm[0]):
        Bt, Qp = _dm_iteration(Bt, Qp, dm_ns)
    for _ in range(wj[0]):
        Bt, Qp = _windowed_jacobi(Bt, Qp, w)
    for _ in range(dm[1]):
        Bt, Qp = _dm_iteration(Bt, Qp, dm_ns)
    for _ in range(wj[1]):
        Bt, Qp = _windowed_jacobi(Bt, Qp, w)
    Bt, Qp = _edge_block(Bt, Qp, polish["edge"], top=False)
    if m >= _STRIP_MIN:  # the JAX package's gate: m, not the strip threshold
        Bt, Qp = _edge_block(*_sort_by_diag(Bt, Qp), polish["edge"], top=True)
    # clusters straddling the bottom-block boundary: one more local sweep
    for _ in range(wj[2]):
        Bt, Qp = _windowed_jacobi(Bt, Qp, w)
    for _ in range(dm[2]):
        Bt, Qp = _dm_iteration(Bt, Qp, dm_ns)

    d = torch.diagonal(Bt)
    E = Bt - torch.diag(d)
    if not eigenvectors:
        # second-order correction Σ_j E_ij²/(d_i − d_j) over well-separated
        # pairs (eigenvector mode skips it: the vectors would lag the values)
        gap0 = d[:, None] - d[None, :]
        ok0 = gap0.abs() > 3.0 * E.abs()
        safe_gap0 = torch.where(gap0 == 0.0, torch.ones_like(gap0), gap0)
        corr = torch.where(ok0, E * E / safe_gap0, torch.zeros_like(E))
        d = d + corr.sum(dim=1)
    order = torch.argsort(d)
    pad = m - n
    evals = d[order][pad:]
    evecs = Qp[:, order][:, pad:] if eigenvectors else None

    if not guarded:
        return evals, evecs, None, None, None

    # defect 1: perturbation bound of the remaining couplings; in eigenvalues
    # mode the pairs the correction handled are third order there
    lmax = d.abs().max() + 1e-30
    I_m = torch.eye(m, dtype=_F32, device=H.device)
    gap = (d[None, :] - d[:, None]).abs() + I_m
    term = torch.minimum(E * E / gap.clamp(min=1e-30), E.abs())
    if not eigenvectors:
        third = E.abs() * torch.square(E / gap0.abs().clamp(min=1e-30))
        term = torch.where(ok0, torch.minimum(third, E.abs()), term)
    bound = (term * (1.0 - I_m)).sum(dim=1).max() / lmax
    # defect 2: orthonormality among the significant columns: the returned
    # eigenvectors, or the pre-polish basis with its own Rayleigh diagonal
    Qc, dq = (evecs, evals) if eigenvectors else (Q, rayleigh0)
    sig = (dq.abs() > 1e-4 * lmax).to(_F32)
    eye_c = torch.eye(Qc.shape[1], dtype=_F32, device=H.device)
    gram_q = (Qc.T @ Qc - eye_c) * (sig[:, None] * sig[None, :])
    orth = torch.linalg.matrix_norm(gram_q) / torch.sqrt(sig.sum() + 1.0)
    return evals, evecs, bound, orth, torch.isnan(d).any()


def _guarded(H, evals, evecs, bound, orth, nan, eigenvectors, guard, return_info):
    """The guard's verdict on a solve's output, and the vendor's result in
    its place past ``guard``."""
    if guard is None:
        return (evals, evecs, no_trip_info(H.device)) if return_info else (evals, evecs)
    bad = (bound > guard) | (orth > guard) | nan
    info = {"tripped": bad, "bound": bound, "orth": orth}
    if bool(bad):  # the solve's one host read
        vendor = "torch.linalg.eigh" if eigenvectors else "torch.linalg.eigvalsh"
        warnings.warn(
            "eigh_dc runtime guard tripped (perturbation bound "
            f"{float(bound):.2e}, orthonormality {float(orth):.2e}): the "
            f"result comes from {vendor}, and this call paid for both "
            "solvers.",
            stacklevel=3,
        )
        if eigenvectors:
            evals, evecs = torch.linalg.eigh(H)
        else:
            evals = torch.linalg.eigvalsh(H)
    return (evals, evecs, info) if return_info else (evals, evecs)


def _deferred(H, evals, evecs, bound, orth, nan, guard, return_info):
    """The guard inside an entry point's captured body, which reads nothing
    on the host: its verdict goes to the entry
    (:func:`vivit_tpu_torch.utils.graphs.guard`), which reads it after the
    replay and, past ``guard``, runs the call again eagerly, where
    :func:`_guarded` warns and takes the vendor's result."""
    if guard is None:
        info = no_trip_info(H.device)
    else:
        bad = (bound > guard) | (orth > guard) | nan
        graphs.guard(bad)
        info = {"tripped": bad, "bound": bound, "orth": orth}
    return (evals, evecs, info) if return_info else (evals, evecs)


def eigvalsh_dc(H: torch.Tensor, *, return_info: bool = False, **kwargs):
    """Eigenvalues-only :func:`eigh_dc`, with its keywords but
    ``eigenvectors``: ``evals`` or ``(evals, info)``."""
    out = eigh_dc(H, eigenvectors=False, return_info=return_info, **kwargs)
    if return_info:
        return out[0], out[2]
    return out[0]


# the keywords eigvalsh_dc passes on, for inspect.signature and help()
eigvalsh_dc.__signature__ = inspect.signature(eigh_dc).replace(parameters=[
    p for p in inspect.signature(eigh_dc).parameters.values() if p.name != "eigenvectors"])


def refine_eigh(H: torch.Tensor, Q: torch.Tensor, key: Optional[int] = None,
                dm_iters=(2, 1)):
    """Refine an approximate eigenbasis ``Q`` of symmetric ``H``: the polish
    alone (two Newton-Schulz steps, ``dm_iters[0]`` Davies-Modi iterations,
    one windowed-Jacobi sweep, ``dm_iters[1]`` more).  ``key`` is accepted
    as in the JAX package; the port's Davies-Modi iteration draws nothing.

    Returns ``(evals ascending, Q_new, residual)``, ``residual`` the relative
    off-diagonal Frobenius norm of ``Q_newᵀ H Q_new`` (~1e-7 from an exact
    basis).  For warm starts from a nearby matrix; check ``residual`` before
    trusting the output (one SGD step can rotate a GGN eigenbasis too far).
    """
    with full_f32():
        for _ in range(2):
            Q = 1.5 * Q - 0.5 * (Q @ (Q.T @ Q))
        Bt, Q = _sort_by_diag(_compress(Q, H), Q)
        for _ in range(dm_iters[0]):
            Bt, Q = _dm_iteration(Bt, Q, 2)
        Bt, Q = _windowed_jacobi(Bt, Q)
        for _ in range(dm_iters[1]):
            Bt, Q = _dm_iteration(Bt, Q, 2)
        d = torch.diagonal(Bt)
        residual = (torch.linalg.matrix_norm(Bt - torch.diag(d))
                    / (torch.linalg.matrix_norm(Bt) + 1e-30))
        order = torch.argsort(d)
        return d[order], Q[:, order], residual
