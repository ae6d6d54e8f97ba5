"""Matrix-free Hessian/GGN analysis over a whole dataset (counterpart of
``vivit_tpu/hessianfree``).

* **Operators on the device** (:func:`ggn_operator`,
  :func:`hessian_operator`): one flat-vector matvec over the dataset.  The
  batches of each distinct size are stacked on the device once and looped
  over in Python, each batch's exact product
  (:func:`vivit_tpu_torch.ggn.ggn_vector_product`,
  :func:`~vivit_tpu_torch.ggn.hessian_vector_product`, full f32) weighted by
  the reference's dataset normalization (``mean``: ``n_batch / N_data``;
  ``sum``: 1), so a ragged last batch is exact.  ``host_stream=True`` keeps
  the batches in host memory and copies them to the card one at a time per
  matvec, for datasets larger than the card's memory.
* **SciPy-compatible wrappers** (:class:`GGNLinearOperator`,
  :class:`HessianLinearOperator`): the ``@``/``matvec`` protocol on numpy
  vectors, ``as_scipy()`` for ARPACK, ``gradient_and_loss`` and the
  reference's determinism self-check.

The model is a model function ``model_fn(params, X)`` with its ``params``
dict, or an ``nn.Module`` with ``params=None``; the parameters must lie on
``device`` (default the CUDA card; ``device="cpu"`` runs on the CPU).  Data
is an iterable of ``(X, y)`` batches (numpy or tensors; a one-shot iterator
is read once).
"""

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from vivit_tpu_torch.ggn import ggn_vector_product, hessian_vector_product
from vivit_tpu_torch.losses import Loss
from vivit_tpu_torch.utils.tree import num_params, ravel, unravel_like


def _resolve(model, params, device):
    """``(model_fn, detached params, device)``, the parameters checked to
    lie on the resolved device."""
    from vivit_tpu_torch.engines import resolve_model
    from vivit_tpu_torch.utils.device import check_params_on, resolve_device

    model_fn, params = resolve_model(model, params)
    device = resolve_device(device)
    check_params_on(params, device, "move the parameters to the device first.")
    return model_fn, {name: p.detach() for name, p in params.items()}, device


def _batch_weights(loss: Loss, batch_sizes, n_data: int) -> List[float]:
    """Per-batch weights of the dataset operator: ``mean`` reduction weighs
    a batch by ``n_batch / N_data``, ``sum`` by 1."""
    if loss.reduction == "mean":
        return [b / n_data for b in batch_sizes]
    return [1.0] * len(batch_sizes)


def _stacks(loss, data, device):
    """The dataset as ``[(Xs [B, n, ...], ys [B, n, ...], weights [B])]`` on
    ``device``, one entry per distinct batch size."""
    from vivit_tpu_torch.utils.device import as_batch

    n_data = sum(X.shape[0] for X, _ in data)
    groups: Dict[int, list] = {}
    for X, y in data:
        groups.setdefault(X.shape[0], []).append(as_batch(X, y, device))
    return [(torch.stack([X for X, _ in group]), torch.stack([y for _, y in group]),
             _batch_weights(loss, [size] * len(group), n_data))
            for size, group in groups.items()]


def _make_operator(model_fn, loss, params, data, product_fn, host_stream: bool,
                   device) -> Callable[[torch.Tensor], torch.Tensor]:
    """The dataset-wide curvature-vector product on flat vectors."""
    from vivit_tpu_torch.utils.device import as_batch

    data = list(data)  # one-shot iterators would be exhausted mid-setup
    if host_stream:
        n_data = sum(X.shape[0] for X, _ in data)
        batches = [(as_batch(X, y, "cpu"), w) for (X, y), w in
                   zip(data, _batch_weights(loss, [X.shape[0] for X, _ in data], n_data))]
    else:
        batches = [((X, y), w) for Xs, ys, weights in _stacks(loss, data, device)
                   for X, y, w in zip(Xs, ys, weights)]

    def matvec(flat_v) -> torch.Tensor:
        flat_v = torch.as_tensor(flat_v, dtype=torch.float32, device=device)
        v = unravel_like(flat_v, params)
        acc = torch.zeros_like(flat_v)
        for (X, y), w in batches:
            gv = product_fn(model_fn, loss, params, X.to(device), y.to(device), v)
            acc = acc + w * ravel(gv)
        return acc

    return matvec


def ggn_operator(model, loss: Loss, params: Optional[Dict[str, torch.Tensor]], data,
                 host_stream: bool = False, device=None) -> Callable:
    """GGN matvec ``flat_v -> G @ flat_v`` over the dataset, on the device
    (flat vectors in :func:`vivit_tpu_torch.utils.tree.ravel` order);
    ``host_stream``: batches stay in host memory (module docstring)."""
    model_fn, params, device = _resolve(model, params, device)
    return _make_operator(model_fn, loss, params, data, ggn_vector_product,
                          host_stream, device)


def hessian_operator(model, loss: Loss, params: Optional[Dict[str, torch.Tensor]], data,
                     host_stream: bool = False, device=None) -> Callable:
    """Hessian matvec over the dataset (see :func:`ggn_operator`)."""
    model_fn, params, device = _resolve(model, params, device)
    return _make_operator(model_fn, loss, params, data, hessian_vector_product,
                          host_stream, device)


def gradient_and_loss(model, loss: Loss, params: Optional[Dict[str, torch.Tensor]], data,
                      device=None) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Dataset gradient ``{name: tensor}`` and loss, with the operators'
    normalization."""
    from torch.func import grad_and_value

    from vivit_tpu_torch.precision import full_f32

    model_fn, params, device = _resolve(model, params, device)
    grad_acc = {name: torch.zeros_like(p) for name, p in params.items()}
    loss_acc = torch.zeros((), dtype=torch.float32, device=device)
    with full_f32():
        for Xs, ys, weights in _stacks(loss, list(data), device):
            for X, y, w in zip(Xs, ys, weights):
                g, value = grad_and_value(lambda p: loss(model_fn(p, X), y))(params)
                grad_acc = {name: a + w * g[name] for name, a in grad_acc.items()}
                loss_acc = loss_acc + w * value
    return grad_acc, loss_acc


class _LinearOperator:
    """SciPy-compatible curvature operator over the dataset; SciPy is
    imported only by :meth:`as_scipy`."""

    _product_fn = None  # set by subclasses

    def __init__(
        self,
        model,
        loss: Loss,
        params: Optional[Dict[str, torch.Tensor]],
        data: Iterable[Tuple[Any, Any]],
        dtype=np.float32,
        progressbar: bool = False,
        check_deterministic: bool = True,
        host_stream: bool = False,
        device=None,
    ):
        # ``progressbar`` is the reference's argument; a matvec is one
        # device loop here, with nothing to show
        del progressbar
        self._model_fn, self._params, self._device = _resolve(model, params, device)
        self._loss = loss
        self._data = list(data)
        dim = num_params(self._params)
        self.shape = (dim, dim)
        self.dtype = np.dtype(dtype)
        self._matvec_fn = _make_operator(self._model_fn, loss, self._params, self._data,
                                         type(self)._product_fn, host_stream, self._device)
        if check_deterministic:
            self._check_deterministic()

    def _matvec(self, x) -> np.ndarray:
        flat = np.asarray(x, dtype=np.float32).reshape(-1)
        return self._matvec_fn(flat).cpu().numpy().astype(self.dtype)

    def matvec(self, x):
        return self._matvec(x)

    def __matmul__(self, x):
        return self._matvec(x)

    def as_scipy(self):
        """A ``scipy.sparse.linalg.LinearOperator`` of this operator."""
        from scipy.sparse.linalg import LinearOperator as ScipyLO

        return ScipyLO(shape=self.shape, dtype=self.dtype, matvec=self._matvec)

    def gradient_and_loss(self):
        """Dataset gradient and loss (:func:`gradient_and_loss`)."""
        return gradient_and_loss(self._model_fn, self._loss, self._params, self._data,
                                 device=self._device)

    def _check_deterministic(self):
        """Two gradient/loss evaluations and two matvecs must agree (the
        reference's rtol 5e-5, atol 1e-6): catches dropout or a shuffling
        data iterator."""
        rtol, atol = 5e-5, 1e-6
        g1, l1 = self.gradient_and_loss()
        g2, l2 = self.gradient_and_loss()
        if not np.allclose(float(l1), float(l2), rtol=rtol, atol=atol):
            raise RuntimeError("Check for deterministic loss failed.")
        if not np.allclose(ravel(g1).cpu().numpy(), ravel(g2).cpu().numpy(),
                           rtol=rtol, atol=atol):
            raise RuntimeError("Check for deterministic gradient failed.")
        v = np.random.default_rng(0).random(self.shape[1]).astype(np.float32)
        if not np.allclose(self @ v, self @ v, rtol=rtol, atol=atol):
            raise RuntimeError("Check for deterministic matvec failed.")


class HessianLinearOperator(_LinearOperator):
    """Hessian of the dataset loss as a linear operator."""

    _product_fn = staticmethod(hessian_vector_product)


class GGNLinearOperator(_LinearOperator):
    """GGN of the dataset loss as a linear operator."""

    _product_fn = staticmethod(ggn_vector_product)


from vivit_tpu_torch.hessianfree.lanczos import (  # noqa: E402
    approximate_boundaries,
    approximate_boundaries_abs,
    fast_lanczos,
    fast_lanczos_jax,
    lanczos_approximate_log_spectrum,
    lanczos_approximate_spectrum,
)
from vivit_tpu_torch.hessianfree.utils import LowRank, Projector  # noqa: E402

__all__ = [
    "GGNLinearOperator",
    "HessianLinearOperator",
    "ggn_operator",
    "hessian_operator",
    "gradient_and_loss",
    "fast_lanczos",
    "fast_lanczos_jax",
    "approximate_boundaries",
    "approximate_boundaries_abs",
    "lanczos_approximate_spectrum",
    "lanczos_approximate_log_spectrum",
    "LowRank",
    "Projector",
]
