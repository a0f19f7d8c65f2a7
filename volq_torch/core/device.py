"""Device selection for the port's entry points: the card unless the
caller asks for the CPU; nothing silently continues on the CPU.  Every
blocking copy between host and card on the frame's path (sim, bakes and
the warp engine's kernel path) goes through ``h2d`` or ``d2h``, which
count it (``core/trace``).  A value fixed by the configuration goes
through ``const`` (and ``scalar``): copied once per process and device,
then served from a cache, so a frame that reads it makes no copy."""
from __future__ import annotations

import numpy as np
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
    """A 0-d fp32 tensor on ``like``'s device (``const``: ``x`` is a
    constant of the configuration).  Divide by this, never by a Python
    float: CUDA divides by a host scalar as a multiply by its rounded
    reciprocal, which is not the fp32 quotient the reference
    computes."""
    return const(x, like.device, torch.float32)


# (value key, dtype, device) -> the tensor, made at version 0
_consts: dict = {}


def _key(x):
    """A hashable key of a number or a nested list / tuple of numbers
    that tells apart every pair of values giving different tensors (a
    float by its exact bits: -0.0 is not 0.0)."""
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    return float(x).hex()


def const(x, device, dtype) -> torch.Tensor:
    """``h2d(x, device, dtype)`` made once per (value, dtype, device) in
    the process and shared after that: the first call copies (counted
    ``const_miss`` and ``h2d``), later ones make no copy (counted
    ``const_hit``).  For values fixed by the configuration; callers only
    read the tensor, and a hit raises if it was written in place."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (_key(x), dtype, device)
    t = _consts.get(key)
    if t is None:
        if device.type != "cpu":
            trace.count("const_miss")
        t = _consts[key] = h2d(x, device, dtype)
        return t
    if t._version:
        raise RuntimeError(f"the cached constant {x!r} ({dtype}, {device}) "
                           "was written in place")
    if device.type != "cpu":
        trace.count("const_hit")
    return t


def clear_consts() -> None:
    """Drop every cached ``const``: the next call of each copies again."""
    _consts.clear()


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
