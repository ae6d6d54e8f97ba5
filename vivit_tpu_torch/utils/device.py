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


def check_params_on(params, device: torch.device, hint: str) -> None:
    """Raise unless every tensor of the ``{name: tensor}`` dict ``params``
    lies on ``device``; ``hint`` says how to move them."""
    for name, p in params.items():
        if p.device != device:
            raise ValueError(
                f"parameter {name!r} lies on {p.device}, not on {device}; {hint}"
            )


def check_module_on(module, device: torch.device) -> None:
    """Raise unless every parameter of ``module`` lies on ``device``."""
    check_params_on(dict(module.named_parameters()), device,
                    "move the module first (module.to(device)).")


def inputs_on(model, X, y, device=None, params=None):
    """``(X, y)`` as an f32 and a target tensor on the resolved ``device``
    (:func:`resolve_device`), after checking that the model's parameters lie
    there: an ``nn.Module``'s own, or the ``params`` dict of a model
    function.  Integer targets keep their dtype; float (regression) targets
    become f32."""
    device = resolve_device(device)
    if params is None:
        check_module_on(model, device)
    else:
        check_params_on(params, device,
                        "move the params dict first ({name: p.to(device)}).")
    return as_batch(X, y, device)


def as_batch(X, y, device):
    """``(X, y)`` on ``device``: ``X`` f32; integer targets keep their dtype,
    float targets become f32."""
    y = torch.as_tensor(y, device=device)
    if y.is_floating_point():
        y = y.float()
    return torch.as_tensor(X, dtype=torch.float32, device=device), y
