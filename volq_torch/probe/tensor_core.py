"""The tensor-core probe (counterpart of ``bench/mxu_probe.py:time_shape``):
repeated small bf16 products with fp32 accumulation on one SM's tensor
cores, at the warp engine's hat-matrix shapes (``csrc/probe_mma.cu``)."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from volq_torch._build import check_tensor, ptr, stream

# shared memory a block can use on the card (bytes)
SMEM_BYTES = 232448
N_SM = 132
PAD = 8          # bf16 elements of padding per shared-memory row

# the reference's shapes (bench/mxu_probe.py): tag, M, K, N
SHAPES = (
    ("full_tile",        128,  128, 128),
    ("c4_dot1_unpaired",  64,   64,  64),
    ("c4_dot1_paired",   128,  128,  64),
    ("c4_dot1_kpack2",    64,  128,  64),
    ("c3_dot1",           80,  128,  64),
    ("c3_dot1_m128",     128,  128,  64),
    ("m_sweep_16",        16,  128, 128),
    ("m_sweep_32",        32,  128, 128),
    ("m_sweep_64",        64,  128, 128),
    ("m_sweep_256",      256,  128, 128),
    ("k_sweep_32",       128,   32, 128),
    ("k_sweep_64",       128,   64, 128),
    ("k_sweep_256",      128,  256, 128),
    ("n_sweep_32",       128,  128,  32),
    ("n_sweep_64",       128,  128,  64),
    ("n_sweep_256",      128,  128, 256),
    ("c4_dot2_paired",   128, 1280, 128),
    ("c4_dot2_swap",      64, 1280,  64),
    ("c3_dot2",           80, 1280,  80),
    ("c3_dot2_m128",     128, 1280,  80),
)
# timed with 8 round-robin accumulators as well
PIPE_SHAPES = (
    ("full_tile",        128,  128, 128),
    ("c4_dot1_unpaired",  64,   64,  64),
    ("c4_dot1_paired",   128,  128,  64),
    ("c3_dot1",           80,  128,  64),
    ("m_sweep_64",        64,  128, 128),
    ("c4_dot2_paired",   128, 1280, 128),
    ("up_tlist",         120,   64,  64),
    ("up_xplace",        120,   64, 256),
)


class MmaParams(ctypes.Structure):
    """Mirrors ``MmaParams`` in csrc/probe_mma.cu."""
    _fields_ = [(n, ctypes.c_int) for n in
                ("R", "M", "K", "N", "G", "Mp", "KC", "resident", "lda",
                 "ldb", "WGM", "WGN")]


class Plan(NamedTuple):
    """How the kernel cuts one shape (see csrc/probe_mma.cu)."""
    Mp: int          # M padded to a multiple of 16
    WGM: int         # warp grid (WGM * WGN == 8)
    WGN: int
    WM: int          # 16x16 output tiles per warp, rows x columns
    WN: int
    nacc: int        # accumulators per tile in use
    resident: bool   # the A stack and B stay in shared memory
    KC: int          # K columns staged at a time
    smem: int        # dynamic shared memory, bytes


def _pow2_at_least(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def smem_bytes(slots: int, Mp: int, KC: int, N: int) -> int:
    """Shared memory of ``slots`` A operands [Mp, KC] and one B [KC, N],
    rows padded by ``PAD``."""
    return 2 * (slots * Mp * (KC + PAD) + KC * (N + PAD))


def mma_plan(R: int, M: int, K: int, N: int, nacc: int) -> Plan:
    if nacc not in (1, 8):
        raise ValueError("nacc must be 1 (chained) or 8 (round-robin)")
    if K % 16 or N % 16 or min(R, M, K, N) < 1:
        raise ValueError("K and N must be multiples of 16")
    Mp = -(-M // 16) * 16
    Mt, Nt = Mp // 16, N // 16
    best = None
    for WGM, WGN in ((8, 1), (4, 2), (2, 4), (1, 8)):
        WM = _pow2_at_least(-(-Mt // WGM))
        WN = _pow2_at_least(-(-Nt // WGN))
        if WM <= 4 and WN <= 4:
            key = (WM * WN, WM + WN)
            if best is None or key < best[0]:
                best = (key, WGM, WGN, WM, WN)
    if best is None:
        raise ValueError(f"output {M} x {N} needs more than 16 tiles a "
                         "warp: at most 256 x 128 or 128 x 256")
    _, WGM, WGN, WM, WN = best
    nacc_eff = 1 if nacc == 1 else min(8, 16 // (WM * WN))
    if smem_bytes(R, Mp, K, N) <= SMEM_BYTES:
        return Plan(Mp, WGM, WGN, WM, WN, nacc_eff, True, K,
                    smem_bytes(R, Mp, K, N))
    for KC in (256, 128, 64, 32, 16):
        if K % KC == 0 and smem_bytes(1, Mp, KC, N) <= SMEM_BYTES:
            return Plan(Mp, WGM, WGN, WM, WN, nacc_eff, False, KC,
                        smem_bytes(1, Mp, KC, N))
    raise ValueError(f"no K chunk of {M} x {K} x {N} fits shared memory")


def mma_probe_plain(A, B, G: int, blocks: int = 1) -> torch.Tensor:
    """Plain PyTorch version: ``G * sum_i A[i] @ B`` in fp64, rounded to
    fp32, once per block.  (The kernel accumulates in fp32 in another
    order: compare within 1e-4 of max |out|.)"""
    one = torch.einsum("imk,kn->mn", A.to(torch.float64),
                       B.to(torch.float64)) * G
    return one.to(torch.float32).expand(blocks, -1, -1)


def mma_probe(A, B, G: int, nacc: int = 1, blocks: int = 1) -> torch.Tensor:
    """``out[blocks, M, N]`` fp32 with ``out[b] = sum_{g<G} sum_{i<R} A[i] @
    B`` for A [R, M, K] and B [K, N] bf16, computed by each of ``blocks``
    thread blocks on its SM's tensor cores.  ``nacc`` = 1 chains every
    product of an output tile through one accumulator, 8 round-robins
    them over up to 8 (``mma_plan(...).nacc`` says how many fit)."""
    dev = A.device
    bf = (torch.bfloat16,)
    if A.dim() != 3 or B.dim() != 2:
        raise ValueError("A must be [R, M, K] and B [K, N]")
    R, M, K = A.shape
    N = B.shape[1]
    check_tensor(A, "A", bf)
    check_tensor(B, "B", bf, (K, N), dev)
    if G < 0 or blocks < 1:
        raise ValueError("G >= 0 and blocks >= 1")
    plan = mma_plan(R, M, K, N, nacc)
    if dev.type != "cuda":
        return mma_probe_plain(A, B, G, blocks)
    from volq_torch._build import load
    fn = load("probe_mma").probe_mma_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [MmaParams] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    p = MmaParams(R=R, M=M, K=K, N=N, G=G, Mp=plan.Mp, KC=plan.KC,
                  resident=int(plan.resident), lda=plan.KC + PAD,
                  ldb=N + PAD, WGM=plan.WGM, WGN=plan.WGN)
    # the kernel writes whole 16-row tiles: the pad rows come back too
    out = torch.empty((blocks, plan.Mp, N), dtype=torch.float32, device=dev)
    err = fn(ptr(A), ptr(B), ptr(out), p, plan.WM, plan.WN, plan.nacc,
             blocks, plan.smem, stream(dev))
    if err:
        raise RuntimeError(f"probe_mma launch failed: CUDA error {err}")
    mma_probe.launches += 1
    return out[:, :M]


mma_probe.launches = 0


def make_inputs(R: int, M: int, K: int, N: int, device, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((R, M, K), generator=g).to(torch.bfloat16).to(device)
    B = torch.randn((K, N), generator=g).to(torch.bfloat16).to(device)
    return A, B


def size_run(M: int, K: int, N: int, target_ms: float = 12.0):
    """(R, G) of a timed launch: R products whose operands stay resident
    in shared memory where one operand pair fits (at most 8; 4 otherwise),
    and G so that a launch lasts about ``target_ms`` at a guessed 2 TFLOP/s
    a block -- a sizing prior only, so that a launch lands within 5-25 ms."""
    Mp = -(-M // 16) * 16
    R = 8
    while R > 1 and smem_bytes(R, Mp, K, N) > SMEM_BYTES:
        R -= 1
    if smem_bytes(R, Mp, K, N) > SMEM_BYTES:
        R = 4
    est_ns = max(2.0 * Mp * K * N / 2e12 * 1e9, 150.0)
    G = int(max(8, min(1 << 20, round(target_ms * 1e6 / (R * est_ns)))))
    return R, G


def time_shape(M: int, K: int, N: int, nacc: int = 1, blocks: int = 1):
    """Median (of 5 launches) seconds per product of [M, K] x [K, N] bf16
    -> fp32 on one block, and the launch's (R, G, plan).  On the card."""
    from volq_torch.probe import median_ms
    R, G = size_run(M, K, N)
    A, B = make_inputs(R, M, K, N, "cuda")
    ms = median_ms(lambda: mma_probe(A, B, G, nacc, blocks))
    return ms * 1e-3 / (R * G), R, G, mma_plan(R, M, K, N, nacc)


def sweep():
    """Time ``SHAPES`` chained and ``PIPE_SHAPES`` round-robin, on one block
    and on one per SM.  Returns a list of dicts; ``tflops`` counts 2*M*K*N
    a product (as the reference does) times the blocks."""
    recs = []
    for shapes, nacc in ((SHAPES, 1), (PIPE_SHAPES, 8)):
        for tag, M, K, N in shapes:
            for nb in (1, N_SM):
                per_dot, R, G, plan = time_shape(M, K, N, nacc, nb)
                recs.append(dict(
                    tag=tag + (":pipe8" if nacc == 8 else ""), M=M, K=K,
                    N=N, blocks=nb, nacc=plan.nacc,
                    resident=plan.resident, KC=plan.KC, R=R, G=G,
                    ns_per_dot=per_dot * 1e9,
                    tflops=2.0 * M * K * N * nb / per_dot / 1e12))
    return recs
