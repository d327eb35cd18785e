"""Device resolution for the port's entry points: the card unless asked."""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device. ``"cpu"`` (or a CPU
    ``torch.device``) runs on the host, which the CPU tests ask for
    explicitly; ``"meta"`` builds a module's structure with no storage. A
    CUDA request without a card raises: the entry points never fall back to
    the CPU on their own. A CUDA device comes back with its index, so two
    resolved devices compare equal exactly when they are the same card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def module_device(module: torch.nn.Module) -> torch.device:
    """The device a module's parameters live on."""
    return next(module.parameters()).device
