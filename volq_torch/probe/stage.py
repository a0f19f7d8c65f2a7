"""The staged-loop probe (counterpart of ``bench/specs_probe.py:run``):
what one step of a sequential loop costs when each step stages K tiles of
4 KB from device memory into shared memory (``csrc/probe_stage.cu``), on
two arms: ``cp_async`` (every thread copies 16 bytes a tile into a ring of
two, a block barrier a step) and ``tma`` (one thread bulk-copies each tile
into a ring of ``depth`` slots, mbarriers between it and the readers)."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from volq_torch import _build
from volq_torch._build import check_tensor, ptr, stream

MAX_K, MAX_SMALL, MAX_CONST = 16, 4, 4
ARMS = ("cp_async", "tma")
DEPTHS = (2, 4, 8)       # the tma arm's ring depths the sweep times
MAX_DEPTH = 8
# the tma arm's default ring depth: the fastest at K 4 in the sweep
DEPTH = 4
SMEM_BYTES = 232448      # shared memory a block can use on the card
TILE, SMALL = 4096, 64   # bytes of a [8, 128] and of a [1, 16] fp32 block
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


class TmaPlan(NamedTuple):
    """The tma arm's shared memory (see csrc/probe_stage.cu)."""
    depth: int
    slot: int        # bytes of a ring slot: K tiles + the small blocks
    smem: int        # the ring, the const tiles and the mbarriers
    copies: tuple    # (bytes, count) of the bulk copies a step, then once


def tma_plan(K: int, n_small: int, n_const: int, depth: int) -> TmaPlan:
    """Raise unless a ring of ``depth`` slots of K tiles (4 KB) and
    ``n_small`` small blocks (64 B), beside ``n_const`` const tiles, fits
    the block's shared memory."""
    if not 2 <= depth <= MAX_DEPTH:
        raise ValueError(f"ring depth must be 2..{MAX_DEPTH}, not {depth}")
    slot = -(-(K * TILE + n_small * SMALL) // 128) * 128
    smem = depth * slot + n_const * TILE + 8 * (2 * MAX_DEPTH + 1)
    if smem > SMEM_BYTES:
        raise ValueError(f"a ring of {depth} slots of {K} tiles and "
                         f"{n_small} small blocks takes {smem} bytes of "
                         f"shared memory ({SMEM_BYTES} a block)")
    return TmaPlan(depth, slot, smem,
                   ((TILE, K), (SMALL, n_small), (TILE, n_const)))


def ring_fits(K: int, n_small: int, n_const: int, depth: int) -> bool:
    """Whether ``tma_plan`` takes this ring."""
    try:
        tma_plan(K, n_small, n_const, depth)
        return True
    except ValueError:
        return False


def stage_probe_plain(xs, small, const, G: int) -> torch.Tensor:
    """Plain PyTorch version: the in-order fp32 sum over n < G of
    ``xs[0][n % M]`` (the other stacks are only fetched by the kernel)."""
    M = xs[0].shape[0]
    acc = torch.zeros((8, 128), dtype=torch.float32, device=xs[0].device)
    for n in range(G):
        acc = acc + xs[0][n % M]
    return acc


def stage_probe(xs, small, const, G: int, arm: str = "tma",
                depth: int | None = None) -> torch.Tensor:
    """``out[8, 128]`` fp32 = sum over n < G, in step order, of
    ``xs[0][n % M]``, while every step also fetches block ``n % M`` of each
    of the K = len(xs) stacks ``[M, 8, 128]`` fp32 and of the ``small``
    stacks ``[M, 1, 16]``; block 0 of each ``const`` stack ``[M, 8, 128]``
    is fetched once.  ``arm``: ``"tma"`` (bulk copies into a ring of
    ``depth`` slots, ``DEPTH`` by default; a ring that does not fit the
    block's shared memory is refused) or ``"cp_async"``."""
    xs, small, const = list(xs), list(small), list(const)
    if not 1 <= len(xs) <= MAX_K or len(small) > MAX_SMALL \
            or len(const) > MAX_CONST or G < 0:
        raise ValueError(f"stage_probe takes 1..{MAX_K} stacks, up to "
                         f"{MAX_SMALL} small and {MAX_CONST} const ones")
    if arm not in ARMS:
        raise ValueError(f"arm must be one of {ARMS}, not {arm!r}")
    dev = xs[0].device
    M = xs[0].shape[0]
    f32 = (torch.float32,)
    for k, x in enumerate(xs):
        check_tensor(x, f"xs[{k}]", f32, (M, 8, 128), dev)
    for k, x in enumerate(small):
        check_tensor(x, f"small[{k}]", f32, (M, 1, 16), dev)
    for k, x in enumerate(const):
        check_tensor(x, f"const[{k}]", f32, (M, 8, 128), dev)
    plan = None
    if arm == "tma":
        plan = tma_plan(len(xs), len(small), len(const),
                        DEPTH if depth is None else depth)
        if any(t.data_ptr() % 16 for t in xs + small + const):
            raise ValueError("the tma arm's bulk copies need every stack "
                             "16-byte aligned")
    elif depth is not None:
        raise ValueError("the cp_async arm's ring is two slots deep")
    if dev.type != "cuda":
        return stage_probe_plain(xs, small, const, G)
    p = StageParams(K=len(xs), n_small=len(small), n_const=len(const), M=M,
                    G=G)
    for field, ts in (("xs", xs), ("small", small), ("cst", const)):
        arr = getattr(p, field)
        for k, t in enumerate(ts):
            arr[k] = t.data_ptr()
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    if arm == "cp_async":
        _build.launch("probe_stage", "probe_stage_launch",
                      [StageParams, ctypes.c_void_p, ctypes.c_void_p], p,
                      ptr(out), stream(dev))
    else:
        _build.launch("probe_stage", "probe_stage_tma_launch",
                      [StageParams, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p],
                      p, plan.depth, plan.slot, ptr(out), stream(dev))
    return out


def fadd_clocks(device="cuda") -> float:
    """SM clocks of one fp32 add that waits on the previous one's result,
    timed on the card over a chain of them (``fadd_chain_kernel``): the
    step of the chain that bounds ``stage_probe``."""
    dev = torch.device(device)
    clocks = torch.zeros(2, dtype=torch.int64, device=dev)
    sink = torch.empty(1, dtype=torch.float32, device=dev)
    _build.launch("probe_stage", "fadd_chain_launch", [ctypes.c_void_p] * 3,
                  ptr(clocks), ptr(sink), stream(dev))
    c, n = clocks.tolist()
    return c / n


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
    """Time the reference's sweep on the card (device time: the median of
    5 graph replays of a launch) on the cp_async arm and on the tma arm at
    every depth of ``DEPTHS`` whose ring fits.  Returns a list of dicts
    (arm, depth, K, G, small, const, ms, ns_per_step)."""
    from volq_torch.probe import median_ms
    recs = []
    for K, G, small, const in SWEEP:
        args = make_inputs(K, small, const, "cuda")
        runs = [("cp_async", None)] + [
            ("tma", d) for d in DEPTHS if ring_fits(K, small, const, d)]
        for arm, depth in runs:
            ms = median_ms(lambda: stage_probe(*args, G, arm, depth))
            recs.append(dict(arm=arm, depth=depth or 2, K=K, G=G,
                             small=small, const=const, ms=ms,
                             ns_per_step=ms * 1e6 / G))
    return recs

