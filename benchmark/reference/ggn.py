"""The plain reference of the curvature queries: the GGN of a network under
the cross-entropy loss with mean reduction, from per-sample Jacobians.

Plain PyTorch, written from the mathematics and independent of the program
under test (it imports nothing of it):

* the loss-Hessian square root of sample ``n``, ``H_n = diag(p) - p p^T``
  with ``p = softmax(f_n)``, as the rows ``s_c = sqrt(p_c) (e_c - p)``,
  scaled by ``sqrt(1/N)`` (mean reduction);
* the null deflation: ``H_n sqrt(p) = 0``, so the rows are rotated onto the
  orthonormal complement of ``sqrt(p)``, the columns ``2..C`` of the
  Householder reflector ``I - v v^T / (1 + u_1)`` with ``u = sqrt(p)``,
  ``v = u + e_1``;
* ``V`` columns ``J_n^T s``, from ``torch.func`` per-sample Jacobians of
  the logits, computed in blocks of samples;
* the Gram ``V^T V``; every block other than a dense layer's weight in the
  configuration's Gram precision, operands rounded to ``low`` and float32
  sums (:func:`low_gram`);
* the eigenvalues.

``dtype`` is the arithmetic (float64 for the reference; float32 with
``tf32=True`` for the control, one step below the configuration's float32).
"""

from contextlib import contextmanager

import torch
from torch import nn
from torch.func import functional_call, jacrev, vmap


@contextmanager
def precision(tf32):
    """Matmuls and convolutions in TF32 or not, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def low_precision_names(module):
    """The parameters whose Gram blocks take the low operand precision:
    all but the weights of ``nn.Linear`` layers."""
    dense = {f"{name}.weight" for name, m in module.named_modules()
             if isinstance(m, nn.Linear)}
    return [name for name, _ in module.named_parameters() if name not in dense]


def loss_factors(f, deflate):
    """``[N, C', C]`` rows of each sample's loss-Hessian square root, scaled
    by ``sqrt(1/N)``; ``C' = C - 1`` with ``deflate``."""
    n, c = f.shape
    p = torch.softmax(f, dim=-1)
    eye = torch.eye(c, dtype=f.dtype, device=f.device)
    s = p.sqrt()[:, :, None] * (eye - p[:, None, :]) / n ** 0.5
    if not deflate:
        return s
    w = complement(p)
    return torch.einsum("nca,nck->nak", w, s)


def complement(p):
    """``[N, C, C-1]``: an orthonormal basis of the complement of
    ``sqrt(p_n)`` for each sample (the Householder columns ``2..C``)."""
    u = p.sqrt()
    c = u.shape[-1]
    v = u.clone()
    v[:, 0] += 1.0
    h = torch.eye(c, dtype=u.dtype, device=u.device) - v[:, :, None] * v[:, None, :] \
        / (1.0 + u[:, 0])[:, None, None]
    return h[:, :, 1:]


def low_gram(block):
    """``block @ block.T`` of low-precision operands with float32 sums."""
    if block.is_cuda and block.dtype != torch.float32:
        return torch.mm(block, block.T, out_dtype=torch.float32)
    return block.float() @ block.float().T


class Columns:
    """``V`` of a batch as ``[C', N, D]`` (factor-major, the parameters
    flattened and concatenated in ``named_parameters`` order), with the
    parameter layout."""

    def __init__(self, module, X, *, deflate, dtype, tf32, block=16):
        params = {name: p.detach().to(dtype) for name, p in module.named_parameters()}
        self.names = list(params)
        self.sizes = [params[n].numel() for n in self.names]
        X = X.to(dtype)

        def logits(p, x):
            return functional_call(module, p, (x[None],))[0]

        per_sample = vmap(jacrev(logits), in_dims=(None, 0))
        with precision(tf32), torch.no_grad():
            f = functional_call(module, params, (X,))
        factors = loss_factors(f, deflate)  # [N, C', C]
        n, cf = X.shape[0], factors.shape[1]
        d = sum(self.sizes)
        self.v = torch.empty((cf, n, d), dtype=dtype, device=X.device)
        with precision(tf32):
            for i in range(0, n, block):
                jac = per_sample(params, X[i:i + block])  # {name: [b, C, *shape]}
                flat = torch.cat([jac[name].flatten(2) for name in self.names], dim=2)
                del jac
                self.v[:, i:i + block] = torch.einsum("bak,bkd->abd", factors[i:i + block],
                                                      flat)
                del flat

    def gram(self, low_names, low, tf32):
        """``[C'N, C'N]`` Gram, summed over the parameters' blocks.  The
        blocks of ``low_names`` follow the configuration's Gram precision:
        operands rounded to ``low`` (through float32, in which the program
        stores them), products summed in float32 (on a card by its GEMM for
        those operands); the other blocks in ``dtype``."""
        cf, n, d = self.v.shape
        flat = self.v.reshape(cf * n, d)
        g = torch.zeros((cf * n, cf * n), dtype=flat.dtype, device=flat.device)
        offset = 0
        with precision(tf32):
            for name, size in zip(self.names, self.sizes):
                block = flat[:, offset:offset + size]
                if name in low_names:
                    g += low_gram(block.float().to(low)).to(flat.dtype)
                else:
                    g += block @ block.T
                offset += size
        return g


def spectrum(module, X, y, *, low, dtype=torch.float64, tf32=False, block=16):
    """The ascending GGN spectrum of the batch, ``N*C`` values: the
    deflated Gram's ``(C-1) N`` eigenvalues and ``N`` exact zeros."""
    cols = Columns(module, X, deflate=True, dtype=dtype, tf32=tf32, block=block)
    g = cols.gram(low_precision_names(module), low, tf32)
    del cols
    evals = torch.linalg.eigvalsh(g)
    return torch.sort(torch.cat([evals.new_zeros(X.shape[0]), evals])).values

