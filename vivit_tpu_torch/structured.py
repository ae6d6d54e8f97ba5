"""Structure-exploiting GGN algebra (counterpart of
``vivit_tpu/structured.py``; the eigenvalue pipeline, the back-projection,
``Vᵀ``-products and the damped Newton step, module form).

For a Linear weight the ``Vᵀ`` column of sample ``n``, factor ``c`` is the
outer product ``δ_{c,n} ⊗ z_n``, so its Gram block is the Hadamard product
``(Z Zᵀ) ∘ (Δ Δᵀ)`` and is never materialized (:class:`DenseFactor`).
Gram matrices use the flat column index ``c·S + n`` (factor-major).
"""

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from vivit_tpu_torch.losses import Loss


@dataclass
class DenseFactor:
    """Kronecker-factored ``Vᵀ`` block of a Linear weight.

    ``z``: layer inputs ``[S, in]``; ``delta``: scaled output cotangents
    ``[CF, S, out]`` (they carry the column scale already).
    """

    z: torch.Tensor
    delta: torch.Tensor

    @property
    def num_cols(self) -> int:
        cf, s = self.delta.shape[:2]
        return cf * s

    def gram(self) -> torch.Tensor:
        """``[CF·S, CF·S]`` Gram block via the Hadamard factorization."""
        cf = self.delta.shape[0]
        zz = self.z @ self.z.T
        df = self.delta.reshape(self.num_cols, -1)
        return (df @ df.T) * zz.repeat(cf, cf)

    def v_mat_prod(self, gram_vecs: torch.Tensor) -> torch.Tensor:
        """``V @ ẽ`` for ``[K, CF·S]`` → ``[K, out, in]`` (weight layout)."""
        cf, s, _ = self.delta.shape
        gv = gram_vecs.reshape(gram_vecs.shape[0], cf, s)
        w = torch.einsum("kcn,cno->kno", gv, self.delta)
        return torch.einsum("kno,ni->koi", w, self.z)

    def vt_mat_prod(self, mat: torch.Tensor) -> torch.Tensor:
        """``Vᵀ @ m`` for ``[K, out, in]`` → ``[CF·S, K]``."""
        w = torch.einsum("ni,koi->kno", self.z, mat)
        r = torch.einsum("kno,cno->cnk", w, self.delta)
        return r.reshape(self.num_cols, r.shape[-1])


def gram_matrix_mixed(
    vt_mixed: Dict[str, Any],
    paths: Optional[Sequence[str]] = None,
    generic_precision=None,
) -> torch.Tensor:
    """Gram over a mixed ``Vᵀ`` dict.

    ``generic_precision`` (an operand dtype from
    :data:`vivit_tpu_torch.precision._PRECISIONS`) applies to the
    materialized blocks (conv weights, biases); the factored Linear blocks
    run in full f32.
    """
    from vivit_tpu_torch.precision import gram
    from vivit_tpu_torch.tapped import ConvVT

    if paths is None:
        paths = list(vt_mixed.keys())
    total = None
    for p in paths:
        leaf = vt_mixed[p]
        if isinstance(leaf, DenseFactor):
            g = leaf.gram()
        elif isinstance(leaf, ConvVT):
            g = leaf.gram(precision=generic_precision)
        else:
            cf, s = leaf.shape[:2]
            g = gram(leaf.reshape(cf * s, -1), generic_precision)
        total = g if total is None else total + g
    return total


def v_mat_prod_mixed(
    vt_mixed: Dict[str, Any],
    gram_vecs: torch.Tensor,
    paths: Sequence[str],
) -> List[torch.Tensor]:
    """Back-projection ``V @ ẽ`` over a mixed ``Vᵀ`` dict: stacked rows
    ``[K, CF·S]`` → one ``[K, *param.shape]`` tensor per path."""
    from vivit_tpu_torch.tapped import ConvVT

    k = gram_vecs.shape[0]
    gv = gram_vecs.reshape(k, -1)
    out = []
    for p in paths:
        leaf = vt_mixed[p]
        if isinstance(leaf, (DenseFactor, ConvVT)):
            out.append(leaf.v_mat_prod(gv))
        else:
            cf, s = leaf.shape[:2]
            out.append((gv @ leaf.reshape(cf * s, -1)).reshape(k, *leaf.shape[2:]))
    return out


def vt_mat_prod_mixed(
    vt_mixed: Dict[str, Any],
    mat_leaves: Sequence[torch.Tensor],
    paths: Sequence[str],
) -> torch.Tensor:
    """``Vᵀ @ m`` over a mixed ``Vᵀ`` dict: ``mat_leaves[i]`` is
    ``[K, *param.shape]`` for ``paths[i]`` → ``[CF·S, K]``."""
    from vivit_tpu_torch.tapped import ConvVT

    total = None
    for p, m in zip(paths, mat_leaves):
        leaf = vt_mixed[p]
        if isinstance(leaf, (DenseFactor, ConvVT)):
            r = leaf.vt_mat_prod(m)
        else:
            cf, s = leaf.shape[:2]
            r = leaf.reshape(cf * s, -1) @ m.reshape(m.shape[0], -1).T
        total = r if total is None else total + r
    return total


def newton_step_structured(
    module: nn.Module,
    loss: Loss,
    X,
    y,
    k: int,
    damping=1.0,
    *,
    subsampling_grad: Optional[Sequence[int]] = None,
    subsampling_ggn: Optional[Sequence[int]] = None,
    mc_samples_ggn: int = 0,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    solver: str = "eigh",
    lobpcg_iters: int = 100,
    deflate_ce_null: bool = False,
    engine: str = "tapped",
    device=None,
) -> List[torch.Tensor]:
    """Damped Newton step along the top-``k`` GGN directions, one tensor
    per parameter in ``named_parameters`` order and layout.

    ``s = Σ_k −γ̄_k / (λ̄_k + δ_k) · e_k`` with the sample means of the
    directional derivatives (:func:`vivit_tpu_torch.optim.utils.gammas_lambdas`)
    and ``damping`` a scalar ``δ`` or a callable ``(evals, gram_evecs,
    gammas, lambdas) -> δ [k]``.  Steps: the undeflated ``Vᵀ`` (tapped
    engine) over the ``subsampling_ggn`` samples, the mixed Gram
    (``gram_precision``), the top-``k`` (``solver`` ``"eigh"``, ``"dc"`` or
    ``"lobpcg"``; with ``deflate_ce_null`` on the Gram-level deflated Gram,
    lifted), per-sample gradients over ``subsampling_grad``, ``Vᵀ g``,
    γ/λ, and the back-projection of the Gram-space step.  ``X`` is NHWC;
    ``device`` defaults to the CUDA card (``device="cpu"`` runs on the CPU).
    In module form this is :func:`vivit_tpu_torch.optim.newton_step_topk`
    over all parameters; ``engine="vjp"`` (the generic engine) is not ported.
    """
    from vivit_tpu_torch.optim.directional_damped_newton import newton_step_topk
    from vivit_tpu_torch.optim.utils import check_ported

    if loss.reduction != "mean":
        raise ValueError("Newton step requires reduction='mean'.")
    check_ported(module, mc_samples_ggn, engine)
    return newton_step_topk(
        module, loss, X, y, k, damping, subsampling_grad=subsampling_grad,
        subsampling_ggn=subsampling_ggn, precision=precision,
        gram_precision=gram_precision, solver=solver, lobpcg_iters=lobpcg_iters,
        deflate_ce_null=deflate_ce_null, device=device)


def eigvalsh_structured(
    module: nn.Module,
    loss: Loss,
    X,
    y,
    *,
    group_paths: Optional[Sequence[Sequence[str]]] = None,
    subsampling: Optional[Sequence[int]] = None,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    eig_backend: str = "xla",
    deflate_ce_null: bool = False,
    return_eig_info: bool = False,
    device=None,
):
    """GGN eigenvalues per parameter group, ascending.

    ``X`` is NHWC (the JAX layout), ``y`` integer targets; both move to
    ``device``, which defaults to the CUDA card (``device="cpu"`` runs on
    the CPU).  ``module``'s parameters must already lie on that device.

    ``gram_precision`` demotes only the materialized Gram contractions
    (``"bf16"``: bf16 operands, f32 result).  ``deflate_ce_null`` (exact
    cross-entropy) solves the ``(C−1)·S`` deflated Gram and returns the
    ``S`` structural zeros exactly.  ``eig_backend`` is ``"xla"`` (vendor
    eigensolver) or ``"dc"`` (:mod:`vivit_tpu_torch.eigdc`).
    ``return_eig_info``: return
    ``(evals_per_group, infos_per_group)`` with the eigensolver's guard info.
    """
    from vivit_tpu_torch.eig import full_eigh
    from vivit_tpu_torch.precision import _PRECISIONS, matmul_precision
    from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt
    from vivit_tpu_torch.utils.device import inputs_on

    if deflate_ce_null:
        from vivit_tpu_torch.deflate import check_deflatable

        check_deflatable(loss)
    X, y = inputs_on(module, X, y, device)

    with matmul_precision(precision):
        vt = tapped_ggn_sqrt_vt(module, loss, X, y, subsampling=subsampling,
                                deflate_ce_null=deflate_ce_null)
        if group_paths is None:
            group_paths = (tuple(n for n, _ in module.named_parameters()),)
        s = X.shape[0] if subsampling is None else len(subsampling)

        evals, infos = [], []
        for paths in group_paths:
            gram = gram_matrix_mixed(
                vt, paths, generic_precision=_PRECISIONS[gram_precision])
            ev, _, info = full_eigh(gram, backend=eig_backend,
                                    eigenvectors=False, return_info=True)
            if deflate_ce_null:
                zeros = torch.zeros(s, dtype=ev.dtype, device=ev.device)
                ev = torch.sort(torch.cat([zeros, ev])).values
            evals.append(ev)
            infos.append(info)
    if return_eig_info:
        return tuple(evals), tuple(infos)
    return tuple(evals)
