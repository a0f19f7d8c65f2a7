"""Device selection for the port's entry points: the card unless the
caller asks for the CPU; nothing silently continues on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises when there is none); otherwise
    the named device, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "volq_torch runs on a CUDA GPU and torch sees none; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 tensor on ``like``'s device.  Divide by this, never by
    a Python float: CUDA divides by a host scalar as a multiply by its
    rounded reciprocal, which is not the fp32 quotient the reference
    computes."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)
