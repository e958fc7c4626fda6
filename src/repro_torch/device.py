"""Device resolution with no hidden fallback."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA: raise when there is no CUDA device.  The CPU is
    used only when the caller asks for it (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on CUDA unless device='cpu' is "
            "passed explicitly")
    return dev


def model_dtype(device: torch.device) -> torch.dtype:
    """The weights' and caches' dtype on ``device``: bf16 on the card,
    whose kernels take bf16, fp32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
