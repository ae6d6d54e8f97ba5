"""Device choice for the port's entry points."""

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA card.

    Raises rather than run on the CPU when no card is present and none was
    asked for: the CPU is a choice the caller makes (``device="cpu"``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vivit_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU."
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_module_on(module, device: torch.device) -> None:
    """Raise unless every parameter of ``module`` lies on ``device``."""
    for name, p in module.named_parameters():
        if p.device != device:
            raise ValueError(
                f"parameter {name!r} lies on {p.device}, not on {device}; "
                "move the module first (module.to(device))."
            )


def inputs_on(module, X, y, device=None):
    """``(X, y)`` as an f32 and an integer tensor on the resolved ``device``
    (:func:`resolve_device`), after checking that ``module`` lies there."""
    device = resolve_device(device)
    check_module_on(module, device)
    return (torch.as_tensor(X, dtype=torch.float32, device=device),
            torch.as_tensor(y, device=device))
