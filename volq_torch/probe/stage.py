"""The staged-loop probe (counterpart of ``bench/specs_probe.py:run``):
what one step of a sequential loop costs when each step stages K tiles of
4 KB from device memory into shared memory (``csrc/probe_stage.cu``)."""
from __future__ import annotations

import ctypes

import torch

from volq_torch._build import check_tensor, ptr, stream

MAX_K, MAX_SMALL, MAX_CONST = 16, 4, 4
# the reference's sweep (bench/specs_probe.py:main): (K, G, small, const)
SWEEP = ((1, 2048, 0, 0), (2, 2048, 0, 0), (4, 2048, 0, 0), (8, 2048, 0, 0),
         (12, 2048, 0, 0), (2, 2048, 3, 0), (2, 2048, 0, 4), (4, 4096, 0, 0),
         (4, 8192, 0, 0))


class StageParams(ctypes.Structure):
    """Mirrors ``StageParams`` in csrc/probe_stage.cu."""
    _fields_ = [("xs", ctypes.c_void_p * MAX_K),
                ("small", ctypes.c_void_p * MAX_SMALL),
                ("cst", ctypes.c_void_p * MAX_CONST)] \
        + [(n, ctypes.c_int) for n in ("K", "n_small", "n_const", "M", "G")]


def stage_probe_plain(xs, small, const, G: int) -> torch.Tensor:
    """Plain PyTorch version: the in-order fp32 sum over n < G of
    ``xs[0][n % M]`` (the other stacks are only fetched by the kernel)."""
    M = xs[0].shape[0]
    acc = torch.zeros((8, 128), dtype=torch.float32, device=xs[0].device)
    for n in range(G):
        acc = acc + xs[0][n % M]
    return acc


def stage_probe(xs, small, const, G: int) -> torch.Tensor:
    """``out[8, 128]`` fp32 = sum over n < G, in step order, of
    ``xs[0][n % M]``, while every step also fetches block ``n % M`` of each
    of the K = len(xs) stacks ``[M, 8, 128]`` fp32 and of the ``small``
    stacks ``[M, 1, 16]``; block 0 of each ``const`` stack ``[M, 8, 128]``
    is fetched once."""
    xs, small, const = list(xs), list(small), list(const)
    if not 1 <= len(xs) <= MAX_K or len(small) > MAX_SMALL \
            or len(const) > MAX_CONST or G < 0:
        raise ValueError(f"stage_probe takes 1..{MAX_K} stacks, up to "
                         f"{MAX_SMALL} small and {MAX_CONST} const ones")
    dev = xs[0].device
    M = xs[0].shape[0]
    f32 = (torch.float32,)
    for k, x in enumerate(xs):
        check_tensor(x, f"xs[{k}]", f32, (M, 8, 128), dev)
    for k, x in enumerate(small):
        check_tensor(x, f"small[{k}]", f32, (M, 1, 16), dev)
    for k, x in enumerate(const):
        check_tensor(x, f"const[{k}]", f32, (M, 8, 128), dev)
    if dev.type != "cuda":
        return stage_probe_plain(xs, small, const, G)
    from volq_torch._build import load
    fn = load("probe_stage").probe_stage_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [StageParams, ctypes.c_void_p, ctypes.c_void_p]
    p = StageParams(K=len(xs), n_small=len(small), n_const=len(const), M=M,
                    G=G)
    for field, ts in (("xs", xs), ("small", small), ("cst", const)):
        arr = getattr(p, field)
        for k, t in enumerate(ts):
            arr[k] = t.data_ptr()
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    err = fn(p, ptr(out), stream(dev))
    if err:
        raise RuntimeError(f"probe_stage launch failed: CUDA error {err}")
    stage_probe.launches += 1
    return out


stage_probe.launches = 0


def make_inputs(K: int, small: int, const: int, device, M: int = 64,
                seed: int = 0):
    """K + small + const distinct random stacks (so that a wrong block or
    stack shows in the sum)."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, dtype=torch.float32).to(device)

    return ([rand(M, 8, 128) for _ in range(K)],
            [rand(M, 1, 16) for _ in range(small)],
            [rand(M, 8, 128) for _ in range(const)])


def sweep():
    """Time the reference's sweep on the card (median of 5 launches).
    Returns a list of dicts (K, G, small, const, ms, ns_per_step)."""
    from volq_torch.probe import median_ms
    recs = []
    for K, G, small, const in SWEEP:
        args = make_inputs(K, small, const, "cuda")
        ms = median_ms(lambda: stage_probe(*args, G))
        recs.append(dict(K=K, G=G, small=small, const=const, ms=ms,
                         ns_per_step=ms * 1e6 / G))
    return recs
