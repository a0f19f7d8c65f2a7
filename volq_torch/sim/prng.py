"""jax.random's threefry2x32 PRNG in torch (jax 0.9.0 semantics with
``jax_threefry_partitionable=True``, its default).

A key is two uint32 words held in an int64 tensor [..., 2]; every
function takes a batch of keys (leading dims) and maps over it, so
``split(keys [N, 2], 7)`` -> [N, 7, 2].  All arithmetic is int64 masked
to 32 bits after every add and shift.  Bits, keys, ``uniform`` and
``randint`` are bit-identical to ``jax.random``.  XLA fuses ``a * b + c`` into one fused multiply-add
(one rounding) inside jitted code, which ``jax.random``'s samplers are:
``_fma`` reproduces that in fp64, where the fp32 product is exact.
``normal`` evaluates XLA's fp32 ``erf_inv`` polynomial (Giles) the same
way, with torch's ``log1p``, which can differ from XLA's by an ulp (see
ROADMAP Queue 3).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from volq_torch.core.device import h2d, resolve_device

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) on broadcastable int64 words
    in [0, 2^32).  Returns the two output words."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x0 = (x1 + k1) & _MASK
    x1 = (x2 + k2) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None):
    """jax.random.PRNGKey(seed) for an int32 seed: [0, seed mod 2^32],
    on ``device`` (None: the card; raises without one)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _hash(keys, counts):
    """threefry(key, (0, count)) for keys [..., 2] and int64 counts of
    shape [*shape]; returns the two words, each [..., *shape]."""
    nb = counts.dim()
    k1 = keys[..., 0].reshape(keys.shape[:-1] + (1,) * nb)
    k2 = keys[..., 1].reshape(keys.shape[:-1] + (1,) * nb)
    return threefry2x32(k1, k2, torch.zeros_like(counts), counts)


def fold_in(keys, data):
    """jax.random.fold_in: threefry(key, (0, uint32(data))).  ``data`` is
    an int or a tensor broadcastable with the key batch."""
    if not torch.is_tensor(data):
        data = h2d(int(data), keys.device, torch.int64)
    data = data.long() & _MASK
    o1, o2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def split(keys, num: int = 2):
    """jax.random.split (fold-like): key i = threefry(key, (0, i))."""
    counts = torch.arange(num, dtype=torch.int64, device=keys.device)
    o1, o2 = _hash(keys, counts)
    return torch.stack([o1, o2], dim=-1)


def random_bits(keys, shape=()):
    """32-bit random words [..., *shape]: bits1 ^ bits2 of threefry over
    the flattened iota."""
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=keys.device) \
        .reshape(shape)
    o1, o2 = _hash(keys, counts)
    return o1 ^ o2


def _fma(a, b, c):
    """fp32 fused multiply-add a * b + c with one rounding: the fp32
    product is exact in fp64 and so, for the operand ranges here, is the
    sum, leaving only the final rounding to fp32."""
    return (a.double() * b + c).float()


def uniform(keys, shape=(), minval=0.0, maxval=1.0):
    """jax.random.uniform in fp32: mantissa bits under exponent 0, then
    floats * (max - min) + min, floored at min."""
    bits = random_bits(keys, shape)
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fb.view(torch.float32) - 1.0
    lo, span = uniform_bounds(minval, maxval)
    lo_t = h2d(np.float32(lo), keys.device)
    return torch.maximum(lo_t, _fma(floats, span, lo))


def uniform_bounds(minval, maxval):
    """``uniform``'s floor and span: fp32(minval) and the fp32 difference
    fp32(maxval) - fp32(minval), as Python floats."""
    lo = np.float32(minval)
    return float(lo), float(np.float32(maxval) - lo)


# XLA's fp32 ErfInv (M. Giles, "Approximating the erfinv function")
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x):
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.full_like(x, _ERFINV_LT5[0]),
                    torch.full_like(x, _ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, torch.full_like(x, a), torch.full_like(x, b))
        p = _fma(p, w.double(), c.double())
    r = p * x
    return torch.where(torch.abs(x) == 1.0, x * math.inf, r)


# normal's uniform floor (-1 + ulp) and its scale, fp32 values
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2)))


def normal(keys, shape=()):
    """jax.random.normal in fp32: sqrt(2) * erfinv(uniform(-1+ulp, 1))."""
    u = uniform(keys, shape, NORMAL_LO, 1.0)
    return SQRT2 * _erfinv_f32(u)


def randint(keys, shape, minval: int, maxval: int):
    """jax.random.randint for int32 [minval, maxval): two 32-bit draws
    from split(key) combined modulo the span (uint32 wrapping math)."""
    k = split(keys, 2)
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    span, mult = randint_span(minval, maxval)
    off = (((hi % span) * mult) & _MASK) + (lo % span)
    off = (off & _MASK) % span
    return (minval + off).to(torch.int32)


def randint_span(minval: int, maxval: int):
    """``randint``'s span and multiplier (2^32 mod span), uint32 ints."""
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (1 << 16) % span
    return span, ((mult * mult) & _MASK) % span
