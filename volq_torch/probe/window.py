"""The window probe (counterpart of ``bench/granule_probe.py:run``): an
ordered fetch / +1 / write-back of [8, 128] fp32 windows of a canvas in
device memory, at x offsets of different alignment
(``csrc/probe_window.cu``), on two arms: ``cp_async`` (16-byte copies, x a
multiple of 4 elements) and ``tma`` (a tensor map with an [8, 128] box,
loads and stores at element coordinates; the copy engine takes those only
in multiples of 16 bytes, so a window at any other x moves as an [8, 132]
box).  One block per 8-row band of the canvas walks that band's windows in
order, several in flight."""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from volq_torch import _build
from volq_torch._build import check_tensor, ptr, stream

H, W = 1088, 2048        # the reference's canvas
WH, WW = 8, 128          # window
N = 4096                 # windows a run
ARMS = ("cp_async", "tma")
# x-offset alignments in elements each arm takes in the sweep: the
# reference's three (128, 16, 8), then 4 (16 bytes, the finest offset a
# 16-byte copy takes) and, on the tma arm, 2 and 1
ALIGNS = {"cp_async": (128, 16, 8, 4), "tma": (128, 16, 8, 4, 2, 1)}
MAX_LIST = 4096          # windows a launch (kMaxList)
_REPO = Path(__file__).resolve().parents[2]


def make_offsets(align: int, n: int = N, h: int = H, w: int = W,
                 seed: int = 0) -> np.ndarray:
    """The reference's offsets: y 8-aligned in [0, h - WH), x
    ``align``-aligned in [0, w - WW), interleaved as int32 [2n]."""
    rng = np.random.RandomState(seed)
    ys = (rng.randint(0, (h - WH) // 8, size=n) * 8).astype(np.int32)
    xs = (rng.randint(0, (w - WW) // align, size=n) * align).astype(np.int32)
    return np.stack([ys, xs], 1).reshape(-1)


def overlap_cases(align: int, n: int = N, h: int = H, w: int = W,
                  seed: int = 0) -> dict:
    """Offsets (int32 [2n], x ``align``-aligned) on which the order of the
    windows matters most: ``one_band``, every window in one 8-row band (the
    longest walk of one block); ``identical``, every window the same (a
    chain of n); ``dense``, x within 256 of the left edge, so that most
    windows overlap the few before them in their band; ``edges``, x at 0
    or at w - 128, the last x the canvas takes (itself aligned only to what
    w - 128 is)."""
    rng = np.random.RandomState(seed)
    band = rng.randint(0, (h - WH) // 8) * 8
    ys = (rng.randint(0, (h - WH) // 8, size=n) * 8).astype(np.int32)

    def pack(y, x):
        y = np.broadcast_to(np.asarray(y, np.int32), (n,))
        return np.stack([y, np.asarray(x, np.int32)], 1).reshape(-1)

    return {
        "one_band": pack(band, rng.randint(0, (w - WW) // align, n) * align),
        "identical": pack(band, np.full(n, (w - WW) // 2 // align * align)),
        "dense": pack(ys, rng.randint(0, 256 // align + 1, n) * align),
        "edges": pack(ys, rng.randint(0, 2, n) * (w - WW))}


def chain_length(offsets) -> int:
    """The longest chain of windows (offsets int32 [2N], y0, x0, ...), in
    the order given, each overlapping an earlier one of the chain: how many
    read-modify-writes of one cell must follow one another, whatever runs
    in parallel.  Two windows overlap when |dy| < 8 and |dx| < 128."""
    o = np.asarray(torch.as_tensor(offsets).cpu(), np.int64)
    ys, xs = o[0::2], o[1::2]
    depth = np.zeros(len(ys), np.int64)
    for j in range(len(ys)):
        hit = (np.abs(ys[:j] - ys[j]) < WH) & (np.abs(xs[:j] - xs[j]) < WW)
        depth[j] = 1 + (depth[:j][hit].max() if hit.any() else 0)
    return int(depth.max()) if len(ys) else 0


def cells_touched(offsets, w: int = W) -> int:
    """Distinct canvas cells that the windows of ``offsets`` (int32 [2N])
    cover on a canvas ``w`` wide: what a run must read and write once."""
    return int(torch.unique(cell_index(offsets, w)).numel())


def cell_index(offsets, w: int = W) -> torch.Tensor:
    """int64 [N * 8 * 128]: the linear index into a canvas ``w`` wide of
    every cell of every window, window by window (row-major in each)."""
    ys, xs = offsets[0::2].long(), offsets[1::2].long()
    rows = torch.arange(WH, device=offsets.device)
    cols = torch.arange(WW, device=offsets.device)
    return ((ys[:, None, None] + rows[None, :, None]) * w
            + xs[:, None, None] + cols[None, None, :]).reshape(-1)


def window_probe_plain(canvas, offsets, align: int) -> torch.Tensor:
    """Plain PyTorch version: the loop, window by window in order (canvas
    updated in place and returned).  Takes any y."""
    off = offsets.tolist()
    for i in range(len(off) // 2):
        y, x = off[2 * i], off[2 * i + 1]
        canvas[y:y + WH, x:x + WW] += 1.0
    return canvas


def window_probe(canvas, offsets, align: int, check_offsets: bool = True,
                 arm: str = "tma") -> torch.Tensor:
    """Add 1 to each of the N windows ``canvas[y:y+8, x:x+128]`` in the
    order ``offsets`` = int32 [2N] (y0, x0, y1, x1, ...) lists them; the
    canvas [H, W] fp32 (W a multiple of 4) is updated in place and
    returned.  Every y must be a multiple of 8, every x a multiple of
    ``align`` elements, and every window inside the canvas.  ``arm``:
    ``"tma"`` (any ``align``) or ``"cp_async"`` (``align`` a multiple of 4:
    16-byte copies).  ``check_offsets=False`` skips the check of the
    offsets' values, which reads them back to the host: for a timed call on
    offsets already checked (the kernel skips a window outside the canvas
    or with a y that is not a multiple of 8; on the tma arm at an ``align``
    that is a multiple of 4, an x that is not faults the copy engine)."""
    if arm not in ARMS:
        raise ValueError(f"arm must be one of {ARMS}, not {arm!r}")
    dev = canvas.device
    check_tensor(canvas, "canvas", (torch.float32,))
    check_tensor(offsets, "offsets", (torch.int32,), device=dev)
    if canvas.dim() != 2 or offsets.dim() != 1 or offsets.numel() % 2:
        raise ValueError("canvas must be [H, W] and offsets [2N]")
    if canvas.shape[1] % 4:
        raise ValueError("the canvas width must be a multiple of 4 elements "
                         "(16 bytes)")
    if align < 1 or (arm == "cp_async" and align % 4):
        raise ValueError(f"the {arm} arm does not take align {align}"
                         + (" (16-byte copies: a multiple of 4 elements)"
                            if arm == "cp_async" else ""))
    ys, xs = offsets[0::2], offsets[1::2]
    n = ys.numel()
    if check_offsets and n and (
            int(ys.min()) < 0 or int(ys.max()) > canvas.shape[0] - WH
            or int(xs.min()) < 0 or int(xs.max()) > canvas.shape[1] - WW
            or bool((xs % align).any())):
        raise ValueError(f"offsets outside the canvas or not {align}-aligned")
    if check_offsets and n and bool((ys % WH).any()):
        raise ValueError("every y must be a multiple of 8 (the windows of "
                         "one 8-row band are walked by one block)")
    if dev.type != "cuda":
        return window_probe_plain(canvas, offsets, align)
    if n == 0:
        return canvas       # nothing to launch, nothing counted
    if canvas.data_ptr() % 16 or offsets.data_ptr() % 8:
        raise ValueError("the canvas must be 16-byte aligned and the "
                         "offsets 8-byte aligned")
    h, w = canvas.shape
    widen = int(align % 4 != 0)    # the tma arm's [8, 132] boxes, if needed
    for i0 in range(0, n, MAX_LIST):       # launches in order on the stream
        window_probe.blocks = _launch(arm, canvas, offsets.data_ptr() + 8 * i0,
                                      min(MAX_LIST, n - i0), h, w, stream(dev),
                                      widen)
    return canvas


def _launch(arm, canvas, off_ptr, n, h, w, st, widen=0) -> int:
    """Launch one arm's kernel on ``n`` <= MAX_LIST windows; returns the
    number of blocks the launcher gave the launch.  ``widen`` (tma): 1
    moves a window whose x is not a multiple of 4 as an [8, 132] box from
    x & ~3; 0 moves every window as an [8, 128] box at its x."""
    args = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
    if arm == "tma":
        name, args, extra = ("probe_window_tma_launch",
                             args + [ctypes.c_int], (widen,))
    else:
        name, extra = "probe_window_launch", ()
    blocks = ctypes.c_int(0)
    _build.launch("probe_window", name,
                  args + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p],
                  ptr(canvas), off_ptr, n, h, w, *extra, ctypes.byref(blocks),
                  st, why=_why)
    return blocks.value


def _why(err: int) -> str:
    """A launcher's code: a CUDA error, or a tensor map refused (< 0)."""
    return f"CUDA error {err}" if err > 0 else f"tensor map refused ({err})"


# the grid of the last launch, as its launcher reports it
window_probe.blocks = 0


def tma_box_at(x: int) -> str:
    """The probe's question put to the copy engine itself: one TMA load and
    store of an [8, 128] fp32 box at element offset ``x`` (no widening).
    Returns ``"taken"``, or the error the card raised.  Runs in a child
    process, since an error of the copy engine ends the CUDA context of the
    process it happens in."""
    code = ("import torch; from volq_torch.probe import window as m; "
            "c = torch.zeros((8, 256), device='cuda'); "
            f"o = torch.tensor([0, {x}], dtype=torch.int32, device='cuda'); "
            "m._launch('tma', c, o.data_ptr(), 1, 8, 256, "
            "torch.cuda.current_stream().cuda_stream, widen=0); "
            "torch.cuda.synchronize(); "
            f"assert bool((c[:, {x}:{x} + 128] == 1).all()); print('taken')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=_REPO)
    if r.returncode == 0:
        return r.stdout.strip().splitlines()[-1]
    raised = [ln for ln in r.stderr.splitlines()
              if re.match(r"[\w.]+(Error|Exception): ", ln)]
    return "refused: " + (raised[-1] if raised else r.stderr.strip()[-200:])


def rt_clocks(device="cuda") -> float:
    """SM clocks of one dependent round trip through L2 -- a 16-byte load,
    the add, the store to the same address that the next load reads --
    timed on the card over a chain of them (``window_rt_kernel``): the
    step of the chain that bounds ``window_probe``."""
    dev = torch.device(device)
    buf = torch.zeros(4, dtype=torch.float32, device=dev)
    clocks = torch.zeros(2, dtype=torch.int64, device=dev)
    _build.launch("probe_window", "window_rt_launch", [ctypes.c_void_p] * 3,
                  ptr(buf), ptr(clocks), stream(dev))
    c, n = clocks.tolist()
    return c / n


def sweep():
    """Time both arms at every alignment each takes, on the reference's
    canvas and N, on the card (device time: the median of 5 graph replays
    of a launch).  Returns a list of dicts (arm, align, chain, ms,
    ns_per_window, box); ``chain`` is ``chain_length`` of the offsets,
    ``box`` on the tma arm at align 4, 2 and 1 ``tma_box_at(align)``:
    whether the copy engine takes an [8, 128] box at that offset (where it
    does not, the arm moves the windows whose x is not a multiple of 4 as
    [8, 132] boxes)."""
    from volq_torch.probe import median_ms
    recs = []
    for align in ALIGNS["tma"]:
        off = torch.from_numpy(make_offsets(align)).to("cuda")
        chain = chain_length(off)
        for arm in ARMS:
            if align not in ALIGNS[arm]:
                continue
            canvas = torch.zeros((H, W), dtype=torch.float32, device="cuda")
            window_probe(canvas, off, align, arm=arm)
            ms = median_ms(lambda: window_probe(canvas, off, align,
                                                check_offsets=False,
                                                arm=arm))
            recs.append(dict(arm=arm, align=align, chain=chain, ms=ms,
                             ns_per_window=ms * 1e6 / N,
                             box=tma_box_at(align)
                             if arm == "tma" and align <= 4 else None))
    return recs
