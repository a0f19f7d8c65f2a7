"""Device selection for the port's entry points: the card unless the
caller asks for the CPU; nothing silently continues on the CPU.  Every
blocking copy between host and card on the frame's path (sim, bakes and
the warp engine's kernel path) goes through ``h2d`` or ``d2h``, which
count it (``core/trace``)."""
from __future__ import annotations

import torch

from volq_torch.core import trace


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
    return h2d(x, like.device, torch.float32)


def h2d(x, device, dtype=None) -> torch.Tensor:
    """``torch.tensor(x, dtype=dtype, device=device)``: on a card a
    blocking copy from host memory, counted ``h2d``."""
    if torch.device(device).type != "cpu":
        trace.count("h2d")
    return torch.tensor(x, dtype=dtype, device=device)


def d2h(t):
    """``t.item()``: on a card a blocking read of the value to the host,
    counted ``d2h``."""
    if t.device.type != "cpu":
        trace.count("d2h")
    return t.item()
