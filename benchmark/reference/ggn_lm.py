"""The plain reference of a language model's GGN-MC spectrum (the Moonlight
cell): per-sequence VJPs of one Monte-Carlo draw of the cross-entropy over
every position, the Gram in the configuration's Gram precision.

Plain PyTorch, written from the mathematics and independent of the program
under test (it imports nothing of it):

* the loss: ``L = 1/(S·T) Σ_{n,t} ℓ(f_{n,t}, y_{n,t})``, the mean over the
  ``S·T`` tokens; one draw ``m`` of sequence ``n`` has the factor
  ``s̃_{n,m} = (p_{n,t} − e_{ŷ_{n,m,t}})_t · √(1/(S·T·M))``, ``p =
  softmax(f)``; its ``V`` column is the VJP ``∂⟨s̃_{n,m}, f(x_n)⟩/∂θ`` of
  the sequence's own forward;
* the draws: each sequence's uniforms ``u [M, T]`` from a CPU generator
  seeded by the splitmix64 finalizer of ``key·φ + n`` (φ =
  0x9E3779B97F4A7C15), the rule the program states for its draws
  (:func:`uniforms`); a label is the first id whose cumulative probability
  exceeds ``u``;
* **the discrete decisions come from the program's side**: the labels and
  the router's top-k choices of one float32 forward are handed in and
  replayed (``net.routing["replay"]``), and each is checked against this
  forward's own float64 numbers: a label is valid where ``u`` lies in its
  CDF interval to within :data:`LABEL_SLACK`, a routing choice where no
  unchosen score beats a chosen one by more than the network's
  ``ROUTING_SLACK`` (relative); the invalid ones are counted, and a count
  above 0 fails the answer.  A rounding that flips a decision would
  otherwise change the GGN itself (``PERF.md`` §7);
* the Gram ``VᵀV`` of the ``S·M`` columns, every block with its operands
  rounded to ``low`` through float32 (the program forms every block of
  this network from bf16 operands: token, routed, embedding and norm
  blocks) and the products summed in ``dtype``, a chunk of parameters at a
  time.

``dtype`` is the arithmetic: float64 for the reference; float32 with
``tf32=True`` for the control, one step below the configuration's float32.
The columns are held rounded, ``S·M`` rows of the parameter count in
``low`` (18.2 GB at 16 sequences and 568 million parameters in bf16),
beside a ``dtype`` copy of the network's tensors (the network itself runs
them, ``torch.func.functional_call``, and is left as it was).
"""

import torch
from torch.func import functional_call

from .ggn import precision

LABEL_SLACK = 1e-6
_MASK64 = (1 << 64) - 1


def _generator(key, sample):
    """The CPU generator of one sequence's draws: splitmix64's finalizer of
    ``key·φ + sample``, its top 63 bits as the seed."""
    x = (int(key) * 0x9E3779B97F4A7C15 + int(sample)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return torch.Generator().manual_seed(x >> 1)


def uniforms(key, s, m, t):
    """``u [S, M, T]`` in float64, sequence ``n`` from :func:`_generator`."""
    return torch.stack([torch.rand((m, t), generator=_generator(key, n), dtype=torch.float64)
                        for n in range(s)])


def labels(f, u, chunk_bytes=1 << 29):
    """``[S, M, T]``: the labels of the uniforms ``u`` under ``softmax(f)``
    (``f [S, T, V]``), the CDF formed in float64 a chunk of positions at a
    time."""
    s, t, v = f.shape
    uu = u.to(f.device).transpose(1, 2).contiguous()  # [S, T, M]
    out = torch.empty(uu.shape, dtype=torch.long, device=f.device)
    step = max(1, chunk_bytes // (8 * s * v))
    for t0 in range(0, t, step):
        cdf = torch.softmax(f[:, t0:t0 + step].double(), dim=-1).cumsum(dim=-1)
        out[:, t0:t0 + step] = torch.searchsorted(cdf, uu[:, t0:t0 + step].contiguous(),
                                                  right=True)
    return out.clamp_(max=v - 1).transpose(1, 2)


def invalid_labels(p, label, u):
    """The draws of one sequence (``p [T, V]`` float64, ``label`` and ``u``
    ``[M, T]``) whose ``u`` lies outside its label's CDF interval by more
    than :data:`LABEL_SLACK`."""
    cdf = p.cumsum(dim=-1)  # [T, V]
    lab = label.to(p.device)
    pos = torch.arange(p.shape[0], device=p.device).expand_as(lab)
    hi = cdf[pos, lab]
    lo = torch.where(lab > 0, cdf[pos, (lab - 1).clamp(min=0)], torch.zeros_like(hi))
    hi = torch.where(lab == p.shape[1] - 1, torch.full_like(hi, float("inf")), hi)
    uu = u.to(p.device)
    return int(((uu < lo - LABEL_SLACK) | (uu >= hi + LABEL_SLACK)).sum())


def _rounded(x, low):
    """``x`` rounded to ``low``, through float32 where ``low`` is narrower
    (the program stores its blocks in float32 before it rounds them)."""
    return x.float().to(low) if low.itemsize < 4 else x.to(low)


def columns(net, X, label, routing, u, *, low, dtype, tf32):
    """``(V [S·M, D] in low, invalid labels, invalid routing choices)``:
    the rounded columns, sequence by sequence, draw ``m`` of sequence ``n``
    in row ``m·S + n`` (the program's factor-major order)."""
    s, m, t = label.shape
    params = {k: p.detach().to(dtype).requires_grad_() for k, p in net.named_parameters()}
    state = {**{k: b.to(dtype) for k, b in net.named_buffers()}, **params}
    numel = sum(p.numel() for p in params.values())
    v = torch.empty((m * s, numel), dtype=low, device=X.device)
    scale = (1.0 / (s * t * m)) ** 0.5
    bad_labels = 0
    net.routing["invalid"] = 0
    with precision(tf32):
        for n in range(s):
            net.routing["replay"] = [r[n * t:(n + 1) * t] for r in routing]
            f = functional_call(net, state, (X[n:n + 1],))[0]  # [T, V]
            p = torch.softmax(f.detach(), dim=-1)
            bad_labels += invalid_labels(p.double(), label[n], u[n])
            for j in range(m):
                seed = p.clone()
                seed[torch.arange(t, device=f.device), label[n, j].to(f.device)] -= 1
                grads = torch.autograd.grad(f, list(params.values()),
                                            grad_outputs=seed * scale, retain_graph=j + 1 < m)
                v[j * s + n] = torch.cat([_rounded(g.reshape(-1), low) for g in grads])
                del grads
            del f, p
    net.routing["replay"] = None
    return v, bad_labels, net.routing["invalid"]


def gram(v, dtype, chunk=1 << 24):
    """``v vᵀ`` of the rounded columns, summed in ``dtype`` a chunk of
    parameters at a time (a product of two bf16 values is exact in float32
    and in TF32)."""
    g = torch.zeros((v.shape[0], v.shape[0]), dtype=dtype, device=v.device)
    for k0 in range(0, v.shape[1], chunk):
        b = v[:, k0:k0 + chunk].to(dtype)
        g += b @ b.T
    return g


def spectrum(net, X, label, routing, u, *, low, dtype=torch.float64, tf32=False):
    """``(ascending GGN-MC spectrum, invalid labels, invalid routing
    choices)`` of the batch ``X [S, T]`` under the handed labels ``[S, M,
    T]`` and routing (``[S·T, k]`` per MoE layer)."""
    v, bad_labels, bad_routing = columns(net, X, label, routing, u, low=low, dtype=dtype,
                                         tf32=tf32)
    with precision(tf32):
        g = gram(v, dtype)
    del v
    return torch.linalg.eigvalsh(g), bad_labels, bad_routing
