"""The tensor-core probe (counterpart of ``bench/mxu_probe.py:time_shape``):
repeated small bf16 products with fp32 accumulation on one SM's tensor
cores, at the warp engine's hat-matrix shapes (``csrc/probe_mma.cu``), on
two arms: ``mma_sync`` (warp-level mma.sync fed by ldmatrix, operands
staged by the threads) and ``wgmma`` (warpgroup-level wgmma on operands
that TMA loads into 128-byte-swizzled shared memory, the K = 1280 shapes
through an mbarrier ring)."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from volq_torch import _build
from volq_torch._build import check_tensor, ptr, stream

# shared memory a block can use on the card (bytes)
SMEM_BYTES = 232448
N_SM = 132
PAD = 8          # bf16 elements of padding per shared-memory row (mma_sync)
ARMS = ("mma_sync", "wgmma")
# the wgmma arm's instantiations (csrc/probe_mma.cu, VOLQ_WG_CASE): (wgmma
# N, 64-row tiles a consumer warpgroup, transposed) -> the accumulators a
# tile under nacc = 8, as many m64nN fp32 tiles (N / 2 registers a thread
# each) as fit in ACC_REGS, at most 8
ACC_REGS = 128
WGMMA_CONFIGS = {
    (16, 1, False): 8, (32, 1, False): 8, (64, 1, False): 4,
    (80, 1, False): 3, (128, 1, False): 2, (128, 2, False): 1,
    (256, 1, False): 1,
    (16, 1, True): 8, (32, 1, True): 8, (80, 1, True): 3,
    (120, 1, True): 2, (120, 2, True): 1,
}
RING_MAX = 8     # slots of the wgmma arm's ring

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


class WgmmaParams(ctypes.Structure):
    """Mirrors ``WgmmaParams`` in csrc/probe_mma.cu."""
    _fields_ = [(n, ctypes.c_int) for n in
                ("R", "M", "K", "N", "G", "Tm", "split", "resident",
                 "stages", "K64", "a_box", "b_chunk", "nc", "b_off", "slot",
                 "bar_off")]


class WgmmaPlan(NamedTuple):
    """How the wgmma arm cuts one shape (see csrc/probe_mma.cu)."""
    trans: bool      # computes out^T = B^T A^T (64-row tiles along N)
    pad: int         # zero rows added to M (direct orientation only)
    n: int           # wgmma N: N direct, M transposed
    Tm: int          # 64-row tiles of the oriented output
    tpw: int         # tiles a consumer warpgroup holds
    split: bool      # the two warpgroups split the products (Tm == 1)
    nacc: int        # accumulators a tile in use
    acc_regs: int    # fp32 accumulator registers a consumer thread
    resident: bool   # every operand loaded once; else the ring
    stages: int      # ring slots (0 when resident)
    KC: int          # K columns a ring stage (K when resident)
    rowsA: int       # rows of A's TMA box (the padded M, or M)
    boxes: tuple     # TMA boxes, innermost first: A's, B's
    useful: float    # share of the issued multiply-adds that are M x N's
    smem: int        # dynamic shared memory, bytes
    params: dict     # the kernel's WgmmaParams fields but R, M, K, N, G


def wgmma_plan(R: int, M: int, K: int, N: int, nacc: int) -> WgmmaPlan:
    """Orientation, tiles, accumulators and operand layout of the wgmma
    arm for ``R`` products of [M, K] x [K, N].  Direct where M % 64 == 0,
    transposed where N % 64 == 0, else M padded to the next 64."""
    if nacc not in (1, 8):
        raise ValueError("nacc must be 1 (chained) or 8 (round-robin)")
    if K % 16 or N % 16 or min(R, M, K, N) < 1:
        raise ValueError("K and N must be multiples of 16")
    if M % 64 == 0:
        trans, pad, n = False, 0, N
    elif N % 64 == 0:
        trans, pad, n = True, 0, M
    else:
        trans, pad, n = False, -M % 64, N
    rowsA = M + pad
    Tm = (N if trans else rowsA) // 64
    if n % 8 or n > 256 or Tm > 4:
        raise ValueError(f"{M} x {K} x {N}: wgmma's N side is {n} (a "
                         f"multiple of 8 up to 256 needed) and {Tm} 64-row "
                         "tiles (at most 4)")
    tpw = 1 if Tm <= 2 else 2
    key = (n, tpw, trans)
    if key not in WGMMA_CONFIGS:
        raise ValueError(f"{M} x {K} x {N}: no wgmma instantiation for N "
                         f"{n}, {tpw} tiles a warpgroup, transposed "
                         f"{trans}")
    split = Tm == 1
    nacc_eff = 1 if nacc == 1 else WGMMA_CONFIGS[key]
    K64, nc, a_box = -(-K // 64), -(-N // 64), rowsA * 128
    red = 256 * n if split else 0     # warpgroup 1's sum, fp32
    common = dict(Tm=Tm, split=int(split), K64=K64, a_box=a_box, nc=nc)
    if K <= 256:
        b_off = R * K64 * a_box
        bar_off = max(b_off + nc * K * 128, red)
        smem = 1024 + bar_off + 16
        if smem <= SMEM_BYTES:
            return WgmmaPlan(
                trans, pad, n, Tm, tpw, split, nacc_eff,
                nacc_eff * tpw * n // 2, True, 0, K, rowsA,
                ((64, rowsA, 1), (64, K)), M * N / (Tm * 64 * n), smem,
                dict(common, resident=1, stages=0, b_chunk=K * 128,
                     b_off=b_off, slot=0, bar_off=bar_off))
    slot = a_box + nc * 8192
    stages = min(RING_MAX, (SMEM_BYTES - 1024 - 16 * RING_MAX) // slot)
    # products split: each warpgroup holds the slot it read last until its
    # next stage arrives, so the producer needs a third
    if stages < (3 if split else 2) or red > stages * slot:
        raise ValueError(f"no ring of {M} x {K} x {N} fits shared memory")
    return WgmmaPlan(
        trans, pad, n, Tm, tpw, split, nacc_eff, nacc_eff * tpw * n // 2,
        False, stages, 64, rowsA, ((64, rowsA, 1), (64, 64)),
        M * N / (Tm * 64 * n), 1024 + stages * slot + 16 * stages,
        dict(common, resident=0, stages=stages, b_chunk=8192, b_off=a_box,
             slot=slot, bar_off=stages * slot))


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


def plan_for(arm: str, R: int, M: int, K: int, N: int, nacc: int):
    """The plan of ``arm`` (``mma_plan`` or ``wgmma_plan``)."""
    if arm not in ARMS:
        raise ValueError(f"arm must be one of {ARMS}, not {arm!r}")
    return (mma_plan if arm == "mma_sync" else wgmma_plan)(R, M, K, N, nacc)


def mma_probe(A, B, G: int, nacc: int = 1, blocks: int = 1,
              arm: str = "wgmma") -> torch.Tensor:
    """``out[blocks, M, N]`` fp32 with ``out[b] = sum_{g<G} sum_{i<R} A[i] @
    B`` for A [R, M, K] and B [K, N] bf16, computed by each of ``blocks``
    thread blocks on its SM's tensor cores, by ``arm``: ``"wgmma"``
    (wgmma on TMA-loaded operands) or ``"mma_sync"``.  ``nacc`` = 1 chains
    every product of an output tile through one accumulator, 8 round-robins
    them over up to 8 (the plan's ``nacc`` says how many fit)."""
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
    plan = plan_for(arm, R, M, K, N, nacc)
    if arm == "wgmma" and (A.data_ptr() % 16 or B.data_ptr() % 16):
        raise ValueError("the wgmma arm's TMA needs A and B 16-byte aligned")
    if dev.type != "cuda":
        return mma_probe_plain(A, B, G, blocks)
    V, I = ctypes.c_void_p, ctypes.c_int
    if arm == "mma_sync":
        p = MmaParams(R=R, M=M, K=K, N=N, G=G, Mp=plan.Mp, KC=plan.KC,
                      resident=int(plan.resident), lda=plan.KC + PAD,
                      ldb=N + PAD, WGM=plan.WGM, WGN=plan.WGN)
        # the kernel writes whole 16-row tiles: the pad rows come back too
        out = torch.empty((blocks, plan.Mp, N), dtype=torch.float32,
                          device=dev)
        _build.launch("probe_mma", "probe_mma_launch",
                      [V] * 3 + [MmaParams] + [I] * 5 + [V], ptr(A), ptr(B),
                      ptr(out), p, plan.WM, plan.WN, plan.nacc, blocks,
                      plan.smem, stream(dev))
    else:
        p = WgmmaParams(R=R, M=M, K=K, N=N, G=G, **plan.params)
        out = torch.empty((blocks, M, N), dtype=torch.float32, device=dev)
        _build.launch("probe_mma", "probe_mma_wgmma_launch",
                      [V] * 3 + [WgmmaParams] + [I] * 7 + [V], ptr(A),
                      ptr(B), ptr(out), p, plan.n, plan.tpw, plan.nacc,
                      int(plan.trans), plan.rowsA, blocks, plan.smem,
                      stream(dev), why=_why)
    return out[:, :M]


def _why(err: int) -> str:
    """The wgmma launcher's own codes: -1, no cuTensorMapEncodeTiled from
    the driver; <= -1000, a tensor map refused (CUresult -1000 - code)."""
    if err == -1:
        return "the driver gives no cuTensorMapEncodeTiled"
    if err <= -1000:
        return f"tensor map refused (CUresult {-1000 - err})"
    return f"CUDA error {err}"


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


def time_shape(M: int, K: int, N: int, nacc: int = 1, blocks: int = 1,
               arm: str = "wgmma"):
    """Median (of 5 graph replays of a launch) device seconds per product
    of [M, K] x [K, N] bf16 -> fp32 on one block by ``arm``, and the
    launch's (R, G, plan).  On the card.  Both arms take the same (R, G):
    ``size_run``'s."""
    from volq_torch.probe import median_ms
    R, G = size_run(M, K, N)
    A, B = make_inputs(R, M, K, N, "cuda")
    ms = median_ms(lambda: mma_probe(A, B, G, nacc, blocks, arm))
    return ms * 1e-3 / (R * G), R, G, plan_for(arm, R, M, K, N, nacc)


def sweep():
    """Time ``SHAPES`` chained and ``PIPE_SHAPES`` round-robin, on one block
    and on one per SM, on each of ``ARMS``.  Returns a list of dicts;
    ``tflops`` counts 2*M*K*N a product (as the reference does) times the
    blocks."""
    recs = []
    for shapes, nacc in ((SHAPES, 1), (PIPE_SHAPES, 8)):
        for tag, M, K, N in shapes:
            for nb in (1, N_SM):
                for arm in ARMS:
                    per_dot, R, G, plan = time_shape(M, K, N, nacc, nb, arm)
                    rec = dict(
                        tag=tag + (":pipe8" if nacc == 8 else ""), arm=arm,
                        M=M, K=K, N=N, blocks=nb, nacc=plan.nacc,
                        resident=plan.resident, KC=plan.KC, R=R, G=G,
                        ns_per_dot=per_dot * 1e9,
                        tflops=2.0 * M * K * N * nb / per_dot / 1e12)
                    if arm == "wgmma":
                        rec.update(trans=plan.trans, n=plan.n,
                                   stages=plan.stages, useful=plan.useful)
                    recs.append(rec)
    return recs
