"""Analytic null-space deflation of the cross-entropy GGN (counterpart of
``vivit_tpu/deflate.py``).

For exact CE factors ``s_{n,c} = √p_c (e_c − p)`` each sample's factor rows
satisfy ``Σ_c √p_{n,c} s_{n,c} = 0``, so the ``[CS, CS]`` Gram carries ``S``
structural zero eigenvalues with known eigenvectors.  Two places use it:

* factor level (:func:`vivit_tpu_torch.ggn.v_factors`): the factor rows are
  projected onto the complement of ``√p_n`` before the backward, so the
  Gram is ``[(C−1)S, (C−1)S]`` from the start (eigenvalues only);
* Gram level (:func:`deflate_gram`, :func:`deflated_eigvalsh`,
  :func:`deflated_topk_eigh`, :func:`deflated_eigh`): the full Gram is
  projected, and eigenvectors are lifted back (:func:`lift_gram_vecs`) to
  the full Gram's, for back-projection.

Gram matrices use the flat index ``c·S + n``.  The projections run in full
f32.
"""

from typing import Optional

import torch

from vivit_tpu_torch.precision import full_f32


def ce_null_complement(probs: torch.Tensor) -> torch.Tensor:
    """Orthonormal complement of the per-sample CE null vectors.

    ``probs [S, C]`` → ``W [S, C, C−1]`` with ``W[n].T @ √p_n = 0``: the
    columns ``1..C−1`` of the Householder reflector
    ``I − v vᵀ/(1+u₁)``, ``u = √p``, ``v = u + e₁``.
    """
    u = probs.sqrt()
    c = u.shape[-1]
    eye = torch.eye(c, dtype=u.dtype, device=u.device)
    v = u + eye[0]  # e₁ (no scalar write: a captured body copies nothing from the host)
    beta = 1.0 / (1.0 + u[:, 0])
    h = eye[None] - beta[:, None, None] * (v[:, :, None] * v[:, None, :])
    return h[:, :, 1:]


def deflate_gram(gram: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Project a ``[CS, CS]`` Gram onto the CE null complement ``w [S, C,
    C−1]`` (:func:`ce_null_complement`): the ``[(C−1)S, (C−1)S]`` deflated
    Gram, factor index major."""
    s, c = w.shape[0], w.shape[1]
    with full_f32():
        g4 = torch.einsum("cndm,nca->andm", gram.reshape(c, s, c, s), w)
        g4 = torch.einsum("andm,mdb->anbm", g4, w)
    return g4.reshape((c - 1) * s, (c - 1) * s)


def deflated_eigvalsh(gram: torch.Tensor, probs: torch.Tensor, *,
                      backend: str = "xla", key: Optional[int] = None,
                      return_info: bool = False):
    """Full ascending spectrum of a CE Gram through exact null deflation:
    the ``S`` structural zeros as exact ``0.0``, the other ``(C−1)·S``
    eigenvalues from the deflated Gram (``backend`` and the int ``key`` as
    in :func:`vivit_tpu_torch.eig.full_eigh`; ``return_info`` adds its
    guard info)."""
    from vivit_tpu_torch.eig import full_eigh

    w = ce_null_complement(probs)
    evals_d, _, info = full_eigh(deflate_gram(gram, w), backend=backend,
                                 eigenvectors=False, key=key, return_info=True)
    evals = torch.sort(torch.cat([evals_d.new_zeros(probs.shape[0]), evals_d])).values
    return (evals, info) if return_info else evals


def ce_null_vectors(probs: torch.Tensor) -> torch.Tensor:
    """The ``S`` analytic null eigenvectors ``[CS, S]``: column ``n`` is the
    unit vector ``√p_n`` on sample ``n``'s rows ``c·S + n``."""
    s, c = probs.shape
    u = probs.sqrt()
    eye = torch.eye(s, dtype=u.dtype, device=u.device)
    return (u.T[:, None, :] * eye[None]).reshape(c * s, s)


def lift_gram_vecs(vecs_d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Lift deflated Gram eigenvectors ``[(C−1)S, K]`` back to ``[CS, K]``:
    the full Gram's eigenvectors of the same (nonzero) eigenvalues."""
    s, c = w.shape[0], w.shape[1]
    with full_f32():
        lifted = torch.einsum("nca,ank->cnk", w, vecs_d.reshape(c - 1, s, -1))
    return lifted.reshape(c * s, -1)


def deflated_eigh(gram: torch.Tensor, probs: torch.Tensor, *,
                  backend: str = "xla", key: Optional[int] = None,
                  return_info: bool = False):
    """Full ascending eigenpairs of a CE Gram through exact null deflation.

    The ``S`` null directions come back as exact zeros with their analytic
    eigenvectors (:func:`ce_null_vectors`); the other pairs are the deflated
    Gram's, lifted (:func:`lift_gram_vecs`).  ``backend`` and the int
    ``key`` as in :func:`vivit_tpu_torch.eig.full_eigh`; ``return_info``
    adds its guard info.
    """
    from vivit_tpu_torch.eig import full_eigh

    w = ce_null_complement(probs)
    evals_d, evecs_d, info = full_eigh(deflate_gram(gram, w), backend=backend,
                                       eigenvectors=True, key=key, return_info=True)
    evals = torch.cat([evals_d.new_zeros(probs.shape[0]), evals_d])
    evecs = torch.cat([ce_null_vectors(probs), lift_gram_vecs(evecs_d, w)], dim=1)
    order = torch.argsort(evals, stable=True)  # the null block first, in order
    out = (evals[order], evecs[:, order])
    return (*out, info) if return_info else out


def deflated_topk_eigh(gram: torch.Tensor, probs: torch.Tensor, k: int, *,
                       solver: str = "eigh", lobpcg_iters: int = 100):
    """Top-``k`` eigenpairs of a CE Gram through exact null deflation:
    ``(evals [k] ascending, evecs [CS, k])``.

    The ``S`` structural zeros are the bottom of the PSD spectrum, so for
    ``k ≤ (C−1)·S`` the deflated Gram's top-``k`` is the full top-``k``.
    """
    from vivit_tpu_torch.eig import topk_eigh

    s, c = probs.shape
    if k > (c - 1) * s:
        raise ValueError(
            f"deflated top-k needs k <= (C-1)*S = {(c - 1) * s} (got {k}): "
            "beyond that the top-k reaches the structural null space."
        )
    w = ce_null_complement(probs)
    evals, evecs_d = topk_eigh(deflate_gram(gram, w), k, solver=solver,
                               lobpcg_iters=lobpcg_iters)
    return evals, lift_gram_vecs(evecs_d, w)


def ce_probs(model, X: torch.Tensor, params=None) -> torch.Tensor:
    """Softmax probabilities of the model outputs (deflation input): an
    ``nn.Module``'s, or ``model(params, X)``'s for a model function."""
    with torch.no_grad():
        f = model(X) if params is None else model(params, X)
        return torch.softmax(f, dim=-1)


def check_deflatable(loss, mc_samples: int = 0) -> None:
    """Raise unless the exact-CE null structure applies."""
    from vivit_tpu_torch.losses import CrossEntropyLoss

    if mc_samples:
        raise ValueError(
            "CE null-space deflation requires exact factors (mc_samples=0): "
            "MC-sampled loss-Hessian roots carry no per-sample dependence."
        )
    if not isinstance(loss, CrossEntropyLoss):
        raise ValueError(
            "CE null-space deflation applies to CrossEntropyLoss only "
            f"(got {type(loss).__name__}); MSE factors are full-rank."
        )
