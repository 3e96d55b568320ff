"""Device resolution: the port runs on the card unless asked for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  A CUDA device without CUDA raises: nothing falls
    back to the CPU quietly — the caller has to pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_device(x, dev: torch.device) -> torch.Tensor:
    """``x`` (a tensor or a numpy array) as a tensor on ``dev``."""
    if not isinstance(x, torch.Tensor):
        from repro_torch.convert import from_reference
        x = from_reference(x)
    return x.to(dev)
