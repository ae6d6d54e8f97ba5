"""Second-order optimization API (counterpart of ``vivit_tpu/optim/``)."""

from vivit_tpu_torch.optim.directional_damped_newton import (
    DirectionalDampedNewtonComputation,
    constant_damping,
    newton_step_topk,
)
from vivit_tpu_torch.optim.directional_derivatives import (
    DirectionalDerivativesComputation,
    directional_derivatives_topk,
)

__all__ = [
    "DirectionalDampedNewtonComputation",
    "DirectionalDerivativesComputation",
    "constant_damping",
    "newton_step_topk",
    "directional_derivatives_topk",
]
