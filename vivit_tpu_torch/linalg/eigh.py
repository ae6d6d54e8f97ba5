"""Top-k GGN eigenpairs with parameter-space back-projection (counterpart
of ``vivit_tpu/linalg/eigh.py``; ``eigh_topk`` and ``backproject`` in this
slice).

``Vᵀ`` transform (tapped engine, undeflated) → Gram ``G̃`` → top-``k``
eigenpairs, optionally through the Gram-level CE deflation
(:func:`vivit_tpu_torch.deflate.deflated_topk_eigh`, lifting the vectors
back to the full Gram) → ``e = V ẽ``, normalized over the group's
parameters.
"""

from typing import List, Optional, Sequence

import torch
from torch import nn

from vivit_tpu_torch.losses import Loss


def backproject(vt, gram_evecs: torch.Tensor, gram_evals: torch.Tensor,
                paths: Sequence[str]) -> List[torch.Tensor]:
    """Normalized parameter-space eigenvectors from Gram eigenvectors
    ``[CF·S, K]``: one ``[K, *param.shape]`` tensor per path.

    The global normalization replaces the exact ``1/√λ`` scale, as in the
    JAX package, so ``gram_evals`` is not used.
    """
    del gram_evals
    from vivit_tpu_torch.gram import normalize
    from vivit_tpu_torch.structured import v_mat_prod_mixed

    return normalize(v_mat_prod_mixed(vt, gram_evecs.T, paths))


def eigh_topk(
    module: nn.Module,
    loss: Loss,
    X,
    y,
    k: int,
    *,
    paths: Optional[Sequence[str]] = None,
    subsampling: Optional[Sequence[int]] = None,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    solver: str = "eigh",
    lobpcg_iters: int = 100,
    deflate_ce_null: bool = False,
    device=None,
):
    """Top-``k`` GGN eigenpairs of one parameter group: ``(evals [k]
    ascending, evecs)``, ``evecs`` one ``[k, *param.shape]`` tensor per path
    (default: all parameters in ``named_parameters`` order).

    ``X`` is NHWC, ``y`` integer targets; both move to ``device``, which
    defaults to the CUDA card (``device="cpu"`` runs on the CPU);
    ``module``'s parameters must already lie there.  ``solver`` is
    ``"eigh"`` (vendor), ``"dc"`` (:mod:`vivit_tpu_torch.eigdc`,
    eigenvector mode) or ``"lobpcg"`` (at most ``lobpcg_iters``
    iterations); ``gram_precision`` demotes the materialized Gram
    contractions (``"bf16"``).  ``deflate_ce_null`` (exact cross-entropy)
    solves the top-``k`` on the deflated ``(C−1)·S`` Gram and lifts the
    vectors back; it needs ``k ≤ (C−1)·S``.
    """
    from vivit_tpu_torch.deflate import check_deflatable, ce_probs, deflated_topk_eigh
    from vivit_tpu_torch.eig import topk_eigh
    from vivit_tpu_torch.precision import _PRECISIONS, matmul_precision
    from vivit_tpu_torch.structured import gram_matrix_mixed
    from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt
    from vivit_tpu_torch.utils.device import inputs_on

    if deflate_ce_null:
        check_deflatable(loss)
    X, y = inputs_on(module, X, y, device)
    if paths is None:
        paths = [name for name, _ in module.named_parameters()]

    with matmul_precision(precision):
        vt = tapped_ggn_sqrt_vt(module, loss, X, y, subsampling=subsampling)
        gram = gram_matrix_mixed(vt, paths,
                                 generic_precision=_PRECISIONS[gram_precision])
        if deflate_ce_null:
            Xs = X if subsampling is None else X[list(subsampling)]
            evals, evecs = deflated_topk_eigh(gram, ce_probs(module, Xs), k,
                                              solver=solver,
                                              lobpcg_iters=lobpcg_iters)
        else:
            evals, evecs = topk_eigh(gram, k, solver=solver,
                                     lobpcg_iters=lobpcg_iters)
        return evals, backproject(vt, evecs, evals, paths)
