"""The window probe (counterpart of ``bench/granule_probe.py:run``): an
ordered fetch / +1 / write-back of [8, 128] fp32 windows of a canvas in
device memory, at x offsets of different alignment
(``csrc/probe_window.cu``)."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from volq_torch._build import check_tensor, ptr, stream

H, W = 1088, 2048        # the reference's canvas
WH, WW = 8, 128          # window
N = 4096                 # windows a run
# x-offset alignments in elements: the reference's three arms, and 4 (16
# bytes), the smallest offset a 16-byte asynchronous copy accepts
ARMS = (128, 16, 8, 4)


def make_offsets(align: int, n: int = N, h: int = H, w: int = W,
                 seed: int = 0) -> np.ndarray:
    """The reference's offsets: y 8-aligned in [0, h - WH), x
    ``align``-aligned in [0, w - WW), interleaved as int32 [2n]."""
    rng = np.random.RandomState(seed)
    ys = (rng.randint(0, (h - WH) // 8, size=n) * 8).astype(np.int32)
    xs = (rng.randint(0, (w - WW) // align, size=n) * align).astype(np.int32)
    return np.stack([ys, xs], 1).reshape(-1)


def cells_touched(offsets, w: int = W) -> int:
    """Distinct canvas cells that the windows of ``offsets`` (int32 [2N])
    cover on a canvas ``w`` wide: what a run must read and write once."""
    ys, xs = offsets[0::2].long(), offsets[1::2].long()
    rows = torch.arange(WH, device=offsets.device)
    cols = torch.arange(WW, device=offsets.device)
    lin = ((ys[:, None, None] + rows[None, :, None]) * w
           + xs[:, None, None] + cols[None, None, :])
    return int(torch.unique(lin).numel())


def window_probe_plain(canvas, offsets, align: int) -> torch.Tensor:
    """Plain PyTorch version: the loop, window by window in order (canvas
    updated in place and returned)."""
    off = offsets.tolist()
    for i in range(len(off) // 2):
        y, x = off[2 * i], off[2 * i + 1]
        canvas[y:y + WH, x:x + WW] += 1.0
    return canvas


def window_probe(canvas, offsets, align: int,
                 check_offsets: bool = True) -> torch.Tensor:
    """Add 1 to each of the N windows ``canvas[y:y+8, x:x+128]`` in the
    order ``offsets`` = int32 [2N] (y0, x0, y1, x1, ...) lists them; the
    canvas [H, W] fp32 is updated in place and returned.  Every x must be a
    multiple of ``align`` elements, itself a multiple of 4 (16 bytes), and
    every window inside the canvas (``check_offsets=False`` skips that
    check of the offsets' values, which reads them back to the host: for a
    timed call on offsets already checked)."""
    dev = canvas.device
    check_tensor(canvas, "canvas", (torch.float32,))
    check_tensor(offsets, "offsets", (torch.int32,), device=dev)
    if canvas.dim() != 2 or offsets.dim() != 1 or offsets.numel() % 2:
        raise ValueError("canvas must be [H, W] and offsets [2N]")
    if align < 4 or align % 4 or canvas.shape[1] % 4:
        raise ValueError("align and the canvas width must be multiples of 4 "
                         "elements (16 bytes)")
    ys, xs = offsets[0::2], offsets[1::2]
    n = ys.numel()
    if check_offsets and n and (
            int(ys.min()) < 0 or int(ys.max()) > canvas.shape[0] - WH
            or int(xs.min()) < 0 or int(xs.max()) > canvas.shape[1] - WW
            or bool((xs % align).any())):
        raise ValueError(f"offsets outside the canvas or not {align}-aligned")
    if dev.type != "cuda":
        return window_probe_plain(canvas, offsets, align)
    if n == 0:
        return canvas       # nothing to launch, nothing counted
    from volq_torch._build import load
    fn = load("probe_window").probe_window_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    err = fn(ptr(canvas), ptr(offsets), n, canvas.shape[1], stream(dev))
    if err:
        raise RuntimeError(f"probe_window launch failed: CUDA error {err}")
    window_probe.launches += 1
    return canvas


window_probe.launches = 0


def sweep():
    """Time every arm on the reference's canvas and N, on the card (device
    time: the median of 5 graph replays of a launch).  Returns a list of
    dicts (align, ms, ns_per_window)."""
    from volq_torch.probe import median_ms
    recs = []
    for align in ARMS:
        off = torch.from_numpy(make_offsets(align)).to("cuda")
        canvas = torch.zeros((H, W), dtype=torch.float32, device="cuda")
        window_probe(canvas, off, align)
        ms = median_ms(lambda: window_probe(canvas, off, align,
                                            check_offsets=False))
        recs.append(dict(align=align, ms=ms, ns_per_window=ms * 1e6 / N))
    return recs
