"""Structure-exploiting GGN algebra (counterpart of
``vivit_tpu/structured.py``; the eigenvalue pipeline and back-projection in
this slice).

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
    from vivit_tpu_torch.utils.device import check_module_on, resolve_device

    device = resolve_device(device)
    if deflate_ce_null:
        from vivit_tpu_torch.deflate import check_deflatable

        check_deflatable(loss)
    check_module_on(module, device)
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, device=device)

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
