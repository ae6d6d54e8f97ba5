"""Structure-exploiting GGN algebra (counterpart of
``vivit_tpu/structured.py``): the structured V-transform of an
``nn.Module`` (tapped or vjp engine), the mixed Gram, back-projection,
``Vᵀ``-products, the eigenvalue pipeline and the damped Newton step.

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


def _linear_inputs(module: nn.Module, X: torch.Tensor):
    """One forward recording each ``nn.Linear``'s input: ``({name: z},
    repeated)``, ``repeated`` the layers applied more than once (weight
    sharing), whose recorded input covers only the last call."""
    captured: Dict[str, torch.Tensor] = {}
    repeated = set()

    def hook_for(name):
        def hook(_, inputs, out):
            if name in captured:
                repeated.add(name)
            captured[name] = inputs[0].detach()
        return hook

    handles = [m.register_forward_hook(hook_for(name))
               for name, m in module.named_modules() if type(m) is nn.Linear]
    try:
        with torch.no_grad():
            module(X)
    finally:
        for h in handles:
            h.remove()
    return captured, repeated


def structured_ggn_sqrt_vt(
    module: nn.Module,
    loss: Loss,
    X: torch.Tensor,
    y: torch.Tensor,
    *,
    subsampling: Optional[Sequence[int]] = None,
    mc_samples: int = 0,
    key: Optional[int] = None,
    batch_size: Optional[int] = None,
    sample_ids=None,
    deflate_ce_null: bool = False,
    engine: str = "tapped",
    conv_vt_dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """Mixed ``Vᵀ`` of a module: ``{name: tensor | DenseFactor | ConvVT}``.

    ``engine="tapped"`` (default): :func:`vivit_tpu_torch.tapped.tapped_ggn_sqrt_vt`,
    its conv blocks stored in ``conv_vt_dtype`` when given (the vjp engine
    ignores the knob, as in the JAX package).
    ``engine="vjp"``: the generic engine (:func:`vivit_tpu_torch.ggn.ggn_sqrt_vt`)
    over every parameter but the weights of Linear layers with a 2-D input,
    a bias and one call site; those become :class:`DenseFactor` blocks of
    the recorded input and the generic bias cotangents (the bias cotangent
    of ``z Wᵀ + b`` is the output cotangent).  The other arguments as in
    :func:`~vivit_tpu_torch.ggn.ggn_sqrt_vt`.
    """
    if engine == "tapped":
        from vivit_tpu_torch.tapped import tapped_ggn_sqrt_vt

        return tapped_ggn_sqrt_vt(
            module, loss, X, y, subsampling=subsampling, mc_samples=mc_samples,
            key=key, batch_size=batch_size, sample_ids=sample_ids,
            deflate_ce_null=deflate_ce_null, conv_vt_dtype=conv_vt_dtype)
    if engine != "vjp":
        raise ValueError(f"Unknown engine {engine!r} (use 'tapped' or 'vjp').")
    from vivit_tpu_torch.engines import forward_fn, module_params
    from vivit_tpu_torch.ggn import _subsample, ggn_sqrt_vt
    from vivit_tpu_torch.utils.checks import check_subsampling_unique

    check_subsampling_unique(subsampling)
    inputs, repeated = _linear_inputs(module, _subsample(X, y, subsampling)[0])
    params = module_params(module)
    factorable = {}
    for name, z in inputs.items():
        prefix = f"{name}." if name else ""
        if name not in repeated and z.dim() == 2 and prefix + "bias" in params:
            factorable[prefix + "weight"] = (z, prefix + "bias")
    diff = {name: p for name, p in params.items() if name not in factorable}
    model_fn = forward_fn(module)

    def model_fn_partial(d, x):
        return model_fn({**params, **d}, x)

    vt = ggn_sqrt_vt(model_fn_partial, loss, diff, X, y, subsampling=subsampling,
                     mc_samples=mc_samples, key=key, batch_size=batch_size,
                     sample_ids=sample_ids, deflate_ce_null=deflate_ce_null)
    for weight, (z, bias) in factorable.items():
        vt[weight] = DenseFactor(z=z, delta=vt[bias])
    return {name: vt[name] for name in params}


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
    key: Optional[int] = None,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    solver: str = "eigh",
    lobpcg_iters: int = 100,
    deflate_ce_null: bool = False,
    engine: str = "tapped",
    conv_vt_dtype: Optional[torch.dtype] = None,
    device=None,
) -> List[torch.Tensor]:
    """Damped Newton step along the top-``k`` GGN directions, one tensor
    per parameter in ``named_parameters`` order and layout.

    ``s = Σ_k −γ̄_k / (λ̄_k + δ_k) · e_k`` with the sample means of the
    directional derivatives (:func:`vivit_tpu_torch.optim.utils.gammas_lambdas`)
    and ``damping`` a scalar ``δ`` or a callable ``(evals, gram_evecs,
    gammas, lambdas) -> δ [k]``.  Steps: the undeflated ``Vᵀ`` (``engine``
    ``"tapped"`` or ``"vjp"``; Monte-Carlo factors with ``mc_samples_ggn``
    and the int ``key``; conv blocks stored in ``conv_vt_dtype``) over the
    ``subsampling_ggn`` samples, the mixed Gram (``gram_precision``), the top-``k`` (``solver`` ``"eigh"``,
    ``"dc"`` or ``"lobpcg"``; with ``deflate_ce_null`` on the Gram-level
    deflated Gram, lifted), per-sample gradients over ``subsampling_grad``,
    ``Vᵀ g``, γ/λ, and the back-projection of the Gram-space step.  ``X``
    is NHWC; ``device`` defaults to the CUDA card (``device="cpu"`` runs on
    the CPU).  This is :func:`vivit_tpu_torch.optim.newton_step_topk` over
    all parameters of the module.
    """
    from vivit_tpu_torch.optim.directional_damped_newton import newton_step_topk

    if loss.reduction != "mean":
        raise ValueError("Newton step requires reduction='mean'.")
    if not isinstance(module, nn.Module):
        raise TypeError("newton_step_structured takes an nn.Module; use "
                        "newton_step_topk(model_fn, ..., params=...) for a model function.")
    return newton_step_topk(
        module, loss, X, y, k, damping, subsampling_grad=subsampling_grad,
        subsampling_ggn=subsampling_ggn, mc_samples_ggn=mc_samples_ggn, key=key,
        precision=precision, gram_precision=gram_precision, solver=solver,
        lobpcg_iters=lobpcg_iters, deflate_ce_null=deflate_ce_null, engine=engine,
        conv_vt_dtype=conv_vt_dtype, device=device)


def eigvalsh_structured(
    module: nn.Module,
    loss: Loss,
    X,
    y,
    *,
    group_paths: Optional[Sequence[Sequence[str]]] = None,
    subsampling: Optional[Sequence[int]] = None,
    mc_samples: int = 0,
    key: Optional[int] = None,
    precision: str = "highest",
    gram_precision: Optional[str] = None,
    eig_backend: str = "xla",
    deflate_ce_null: bool = False,
    engine: str = "tapped",
    conv_vt_dtype: Optional[torch.dtype] = None,
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
    ``mc_samples``/``key``: Monte-Carlo factors; ``engine``: ``"tapped"``
    or ``"vjp"`` (:func:`structured_ggn_sqrt_vt`); ``conv_vt_dtype``: the
    conv blocks' storage dtype (``torch.bfloat16`` beside the bf16 Gram
    gives the same Gram).  ``return_eig_info``:
    return ``(evals_per_group, infos_per_group)`` with the eigensolver's
    guard info.
    """
    from vivit_tpu_torch.eig import full_eigh
    from vivit_tpu_torch.precision import _PRECISIONS, matmul_precision
    from vivit_tpu_torch.utils.device import inputs_on

    if deflate_ce_null:
        from vivit_tpu_torch.deflate import check_deflatable

        check_deflatable(loss, mc_samples)
    X, y = inputs_on(module, X, y, device)

    with matmul_precision(precision):
        vt = structured_ggn_sqrt_vt(module, loss, X, y, subsampling=subsampling,
                                    mc_samples=mc_samples, key=key,
                                    deflate_ce_null=deflate_ce_null, engine=engine,
                                    conv_vt_dtype=conv_vt_dtype)
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
