"""The warp engine's kernels (counterpart of ``volq/render/kernel.py``).

The TPU's fused ``march_warp_pallas`` (unlit, unpaired, slab banks) is
split where its work stops being per-particle:

* ``warp_march`` (kernel A, ``csrc/warp_march.cu``): per depth-ordered
  particle, the telescoped march over its slab stack, the fan shift at
  march resolution and P2 = 1 - exp(-q) -> P2m [N, RM, RM] fp32 plus the
  shift-clamp count;
* ``warp_composite`` (kernel B, ``csrc/warp_composite.cu``): per canvas
  tile, the hat upsample of each covering particle's P2m into canvas
  coordinates and the OVER read-modify-write, in depth order.

Each wrapper launches its CUDA kernel for tensors on the card (raising
if it cannot) and runs its plain PyTorch version, ``*_plain``, only for
tensors on the CPU.  The plain versions repeat the kernels' arithmetic
op for op (same rounding points, same fp32 operation order), so on the
card kernel B is bit-equal to its plain version and kernel A equal to
fp32 rounding.  ``launches`` on each wrapper counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from volq_torch.scene.config import SceneConfig

# per-particle geometry columns of warp_march's ``pgeom`` [N, PG_N]
(PG_LOX, PG_LOY, PG_LOZ, PG_EXT, PG_SCALE, PG_SZN, PG_VALID, PG_SX0,
 PG_SY0, PG_PXC, PG_PYC, PG_N) = range(12)


def _f32(x) -> float:
    """A Python float rounded to fp32 (how JAX uses a weak Python scalar
    in fp32 arithmetic)."""
    return float(np.float32(x))


class CanvasGeom(NamedTuple):
    """Fused-path canvas geometry (pixel canvas; the coarse / scaled /
    interleaved layouts of ``volq/render/kernel.py:CanvasGeom`` are not
    ported).  ``WH``/``WW`` are the TPU window dims, kept because they
    size the canvas padding the reference's canvas has; the port
    composites per pixel."""
    WH: int
    WW: int
    Hc: int
    Wc: int
    pad: int


def canvas_geom(cfg: SceneConfig, h_local: int) -> CanvasGeom:
    from volq_torch.render.warp import check_supported
    check_supported(cfg)
    r = cfg.render
    RP = r.warp_rect
    WH = -(-(RP + 8) // 8) * 8
    WW = -(-(128 + RP) // 128) * 128
    return CanvasGeom(WH=WH, WW=WW, Hc=h_local + RP + WH,
                      Wc=r.width + RP + WW, pad=RP)


def canvas_init(cfg: SceneConfig, h_local: int, device) -> torch.Tensor:
    """Padded canvas [4, Hc, Wc]: C = 0, T = 1, bf16 unless
    warp_canvas_fp32 (plain torch; the TPU version was no kernel)."""
    g = canvas_geom(cfg, h_local)
    cdt = torch.float32 if cfg.render.warp_canvas_fp32 else torch.bfloat16
    c = torch.zeros((4, g.Hc, g.Wc), dtype=cdt, device=device)
    c[3] = 1
    return c


def _check(t: torch.Tensor, name: str, dtypes, shape=None, device=None):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# --------------------------------------------------------------------------
# kernel A: warp_march

class MarchParams(ctypes.Structure):
    """Scalar parameters of warp_march (mirrors ``MarchParams`` in
    csrc/warp_march.cu).  The float fields are fp32 roundings of the
    reference's Python-double constants."""
    _fields_ = [(n, ctypes.c_int) for n in
                ("N", "S", "VX", "V", "RM", "row_fan")] + \
               [(n, ctypes.c_float) for n in
                ("gsc", "gscx", "Sf", "ratio", "Kc", "Kc_hi", "rm_hi", "W",
                 "H", "two_over_W", "two_over_H")]


def march_params(N: int, S: int, VX: int, V: int, RM: int, RP: int,
                 K: int, row_fan: bool, W: int, H: int) -> MarchParams:
    ratio = (RP - 1.0) / max(RM - 1, 1)
    Kc = K / ratio
    return MarchParams(
        N=N, S=S, VX=VX, V=V, RM=RM, row_fan=int(row_fan),
        gsc=_f32(V - 1), gscx=_f32(VX - 1), Sf=_f32(S), ratio=_f32(ratio),
        Kc=_f32(Kc), Kc_hi=_f32(Kc - 1e-3), rm_hi=_f32(RM - 1.0 - 1e-3),
        W=_f32(W), H=_f32(H), two_over_W=_f32(2.0 / W),
        two_over_H=_f32(2.0 / H))


def _hat(g, k, n: int, wdt):
    """Hat weight of integer tap k at position g, rounded to the working
    type, 0 where k is outside [0, n)."""
    w = torch.clamp(1.0 - torch.abs(g - k.to(torch.float32)), min=0.0)
    w = w.to(wdt).to(torch.float32)
    return torch.where((k >= 0) & (k < n), w, torch.zeros_like(w))


def _safe_div(num, den):
    sgn = torch.where(den >= 0, 1.0, -1.0)
    return num / (sgn * torch.clamp(torch.abs(den), min=1e-12))


def _axis_seg(o, d, lo, hi):
    sgn = torch.where(d >= 0, 1.0, -1.0)
    dsafe = torch.where(torch.abs(d) < 1e-12, sgn * 1e-12, d)
    inv = torch.ones_like(dsafe) / dsafe
    ta = (lo - o) * inv
    tb = (hi - o) * inv
    return torch.minimum(ta, tb), torch.maximum(ta, tb)


def _shift(x, delta, idx, axis: int):
    """Linear interpolation of x [N, RM(j), RM(i)] at index idx + delta
    along ``axis`` (2: across columns i, 1: across rows j): the combined-
    weight shift of the reference, whose only non-zero taps are floor
    and floor + 1 (the clamps keep both inside the plane)."""
    d0 = torch.floor(delta)
    fr = delta - d0
    i0 = (idx + d0).to(torch.int64)
    a = torch.gather(x, axis, i0)
    b = torch.gather(x, axis, i0 + 1)
    return (1.0 - fr) * a + fr * b


def warp_march_plain(bank, vidx, pgeom, rx_u, ry_w, camf,
                     p: MarchParams):
    """Plain PyTorch version of kernel A (same arithmetic).  Returns
    (P2m [N, RM, RM] fp32, clamp count [1] int32)."""
    dev = pgeom.device
    f32 = torch.float32
    N, RM, S = p.N, p.RM, p.S
    wdt = bank.dtype
    col = lambda c: pgeom[:, c].reshape(N, 1, 1)      # noqa: E731
    lo_x, lo_y, lo_z = col(PG_LOX), col(PG_LOY), col(PG_LOZ)
    ext, scale, szn = col(PG_EXT), col(PG_SCALE), col(PG_SZN)
    valid = col(PG_VALID) > 0
    eye_x, eye_y, eye_z = camf[0], camf[1], camf[2]
    rx = rx_u[:, None, :]                               # [N, 1, RM] (i)
    ry = ry_w[:, :, None]                               # [N, RM, 1] (j)

    # ray/AABB: geo = scale * min(dt_raw, seg)
    rnorm = torch.sqrt(rx * rx + ry * ry + 1.0)
    inv_n = torch.ones_like(rnorm) / rnorm
    d_x = rx * inv_n * szn
    d_y = ry * inv_n * szn
    d_z = inv_n * szn
    Sf = torch.tensor(p.Sf, dtype=f32, device=dev)
    dt_raw = (ext / Sf) * rnorm
    t0x, t1x = _axis_seg(eye_x, d_x, lo_x, lo_x + ext)
    t0y, t1y = _axis_seg(eye_y, d_y, lo_y, lo_y + ext)
    t0z, t1z = _axis_seg(eye_z, d_z, lo_z, lo_z + ext)
    t0 = torch.maximum(torch.maximum(t0x, t0y), torch.clamp(t0z, min=0.0))
    t1 = torch.minimum(torch.minimum(t1x, t1y), t1z)
    seg = torch.clamp(t1 - t0, min=0.0)
    geo = scale * torch.minimum(dt_raw, seg)

    # telescoped march: od = sum_s sum_{a taps} rnd(t1[a]) * wx[a]
    kx2 = torch.tensor(p.gscx, dtype=f32, device=dev) / ext
    ky2 = torch.tensor(p.gsc, dtype=f32, device=dev) / ext
    bx_h = (eye_x - lo_x) * kx2
    by_h = (eye_y - lo_y) * ky2
    stacks = bank[vidx.long()]                          # [N, S, VX, V]
    n_idx = torch.arange(N, device=dev).reshape(N, 1, 1)
    od = torch.zeros((N, RM, RM), dtype=f32, device=dev)
    for s in range(S):
        zeta = float(np.float32(np.float32(s) + np.float32(0.5))
                     / np.float32(p.Sf))
        zw = lo_z + zeta * ext
        c1 = zw - eye_z
        gx = bx_h + (c1 * kx2) * rx                     # [N, 1, RM]
        gy = by_h + (c1 * ky2) * ry                     # [N, RM, 1]
        tpos = (zw - eye_z) * szn > 0
        gyc = torch.where((gy >= 0) & (gy <= p.gsc) & tpos, gy, -2.0)
        gxc = torch.where((gx >= 0) & (gx <= p.gscx), gx, -2.0)
        b0 = torch.floor(gyc).to(torch.int64)
        a0 = torch.floor(gxc).to(torch.int64)
        wy0, wy1 = _hat(gyc, b0, p.V, wdt), _hat(gyc, b0 + 1, p.V, wdt)
        wx0, wx1 = _hat(gxc, a0, p.VX, wdt), _hat(gxc, a0 + 1, p.VX, wdt)
        slab = stacks[:, s]                             # [N, VX, V]

        def tap(a, b):
            a = a.clamp(0, p.VX - 1).expand(N, RM, RM)
            b = b.clamp(0, p.V - 1).expand(N, RM, RM)
            return slab[n_idx, a, b].to(f32)

        for a, wx in ((a0, wx0), (a0 + 1, wx1)):
            t1v = wy0 * tap(a, b0) + wy1 * tap(a, b0 + 1)
            t1v = t1v.to(wdt).to(f32)
            od = od + t1v * wx
    q = od * geo

    # fan shift (closed form of render/warp.fan_shifts), column pass
    g1 = lambda c: pgeom[:, c].reshape(N, 1, 1)         # noqa: E731
    sx0, sy0, pxc, pyc = g1(PG_SX0), g1(PG_SY0), g1(PG_PXC), g1(PG_PYC)
    rxc, ryc, rzc = camf[3], camf[4], camf[5]
    uxc, uyc, uzc = camf[6], camf[7], camf[8]
    fwd_x, fwd_y, fwd_z = camf[9], camf[10], camf[11]
    sxs, sys_ = camf[12], camf[13]
    W = torch.tensor(p.W, dtype=f32, device=dev)
    H = torch.tensor(p.H, dtype=f32, device=dev)
    dox_step = 2.0 * sxs / W * p.ratio
    doy_step = -2.0 * sys_ / H * p.ratio
    dyk = 2.0 * sys_ / H
    dxk = 2.0 * sxs / W
    ii = torch.arange(RM, dtype=f32, device=dev).reshape(1, 1, RM)
    jj = torch.arange(RM, dtype=f32, device=dev).reshape(1, RM, 1)
    iv, jv = ii * p.ratio, jj * p.ratio
    doy_j = (pyc - (sy0 + jv + 0.5)) * dyk              # [N, RM(j), 1]
    ox_i = ((sx0 + iv + 0.5) * p.two_over_W - 1.0) * sxs  # [N, 1, RM(i)]
    oy_c = (1.0 - pyc * p.two_over_H) * sys_
    D_ic = fwd_z + ox_i * rzc + oy_c * uzc
    Nx_ic = fwd_x + ox_i * rxc + oy_c * uxc
    Fy_i = uxc * D_ic - Nx_ic * uzc
    Gx_i = rxc * D_ic - Nx_ic * rzc
    D_ip1 = D_ic + dox_step * rzc
    D_ij = D_ic + doy_j * uzc
    A_i = _safe_div(Fy_i * D_ip1, dox_step * Gx_i)
    du = _safe_div(doy_j * A_i, D_ij)
    clamped = ((du < -p.Kc) | (du > p.Kc_hi)) & valid
    du = torch.clamp(du, -p.Kc, p.Kc_hi)
    du = torch.maximum(du, -ii)
    du = torch.minimum(du, p.rm_hi - ii)
    n_clamp = clamped.sum()
    x = _shift(q, du, ii.expand_as(du), 2)

    if p.row_fan:
        dox_i = ((sx0 + iv + 0.5) - pxc) * dxk          # [N, 1, RM(i)]
        oy_j = (1.0 - (sy0 + jv + 0.5) * p.two_over_H) * sys_
        ox_c = (pxc * p.two_over_W - 1.0) * sxs
        D_cj = fwd_z + oy_j * uzc + ox_c * rzc          # [N, RM(j), 1]
        Ny_cj = fwd_y + oy_j * uyc + ox_c * ryc
        Fx_j = ryc * D_cj - Ny_cj * rzc
        Gy_j = uyc * D_cj - Ny_cj * uzc
        D_jp1 = D_cj + doy_step * uzc
        D_ij2 = D_cj + dox_i * rzc
        B_j = _safe_div(Fx_j * D_jp1, doy_step * Gy_j)
        dw = _safe_div(dox_i * B_j, D_ij2)
        clamped_y = ((dw < -p.Kc) | (dw > p.Kc_hi)) & valid
        dw = torch.clamp(dw, -p.Kc, p.Kc_hi)
        dw = torch.maximum(dw, -jj)
        dw = torch.minimum(dw, p.rm_hi - jj)
        n_clamp = n_clamp + clamped_y.sum()
        x = _shift(x, dw, jj.expand_as(dw), 1)

    P2m = 1.0 - torch.exp(-x)
    P2m = torch.where(valid, P2m, torch.zeros_like(P2m))
    return P2m, n_clamp.to(torch.int32).reshape(1)


def warp_march(bank, vidx, pgeom, rx_u, ry_w, camf, p: MarchParams):
    """Kernel A: march + fan + exp of the depth-ordered particles.
    ``bank`` [M, S, VX, V] (bf16 or fp32 slab bank), ``vidx`` [N] int32,
    ``pgeom`` [N, PG_N] fp32, ``rx_u``/``ry_w`` [N, RM] fp32, ``camf``
    [16] fp32 (eye, right, up, fwd, scale_x, scale_y).  Returns (P2m
    [N, RM, RM] fp32, clamp count [1] int32)."""
    dev = pgeom.device
    N, RM = p.N, p.RM
    _check(bank, "bank", (torch.bfloat16, torch.float32),
           (bank.shape[0], p.S, p.VX, p.V), dev)
    _check(vidx, "vidx", (torch.int32,), (N,), dev)
    _check(pgeom, "pgeom", (torch.float32,), (N, PG_N), dev)
    _check(rx_u, "rx_u", (torch.float32,), (N, RM), dev)
    _check(ry_w, "ry_w", (torch.float32,), (N, RM), dev)
    _check(camf, "camf", (torch.float32,), (16,), dev)
    if dev.type != "cuda":
        return warp_march_plain(bank, vidx, pgeom, rx_u, ry_w, camf, p)
    from volq_torch.render._build import load
    fn = load("warp_march").warp_march_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7 \
        + [MarchParams, ctypes.c_void_p]
    P2m = torch.empty((N, RM, RM), dtype=torch.float32, device=dev)
    clamp = torch.zeros((1,), dtype=torch.int32, device=dev)
    err = fn(_ptr(bank), int(bank.dtype == torch.bfloat16), _ptr(vidx),
             _ptr(pgeom), _ptr(rx_u), _ptr(ry_w), _ptr(camf), _ptr(P2m),
             _ptr(clamp), p, _stream(dev))
    if err:
        raise RuntimeError(f"warp_march launch failed: CUDA error {err}")
    warp_march.launches += 1
    return P2m, clamp


warp_march.launches = 0


# --------------------------------------------------------------------------
# kernel B: warp_composite

class CompositeParams(ctypes.Structure):
    """Mirrors ``CompositeParams`` in csrc/warp_composite.cu."""
    _fields_ = [(n, ctypes.c_int) for n in ("N", "RM", "RP", "Hc", "Wc")] \
        + [("ratio_m", ctypes.c_float)]


def composite_params(N: int, RM: int, RP: int, Hc: int,
                     Wc: int) -> CompositeParams:
    ratio_m = float(np.float32(RM - 1) / np.float32(max(RP - 1, 1)))
    return CompositeParams(N=N, RM=RM, RP=RP, Hc=Hc, Wc=Wc, ratio_m=ratio_m)


def _taps(g, n: int, pdt):
    """Two hat taps (floor, floor + 1) of positions g on [0, n)."""
    k0 = torch.floor(g).to(torch.int64)
    return k0, _hat(g, k0, n, pdt), _hat(g, k0 + 1, n, pdt)


def warp_composite_plain(canvas, P2m, ayf, axf, cc, valid,
                         p: CompositeParams, pdt):
    """Plain PyTorch version of kernel B: particle by particle in depth
    order, the placed P2 of its rect and the OVER RMW of the canvas
    (updated in place and returned)."""
    f32 = torch.float32
    RP, RM = p.RP, p.RM
    cdt = canvas.dtype
    pos = torch.arange(RP, dtype=f32, device=canvas.device) * p.ratio_m
    k0, wy0, wy1 = _taps(pos, RM, pdt)       # rows: the same for every
    m0, wx0, wx1 = _taps(pos, RM, pdt)       # particle (integer origins)
    k1 = (k0 + 1).clamp(max=RM - 1)
    m1 = (m0 + 1).clamp(max=RM - 1)
    keep = valid.to(torch.bool).tolist()
    y0s = ayf.to(torch.int64).tolist()
    x0s = axf.to(torch.int64).tolist()
    for k in range(p.N):
        if not keep[k]:
            continue
        P = P2m[k].to(pdt).to(f32)
        t = wy0[:, None] * P[k0] + wy1[:, None] * P[k1]      # [RP, RM]
        t = t.to(pdt).to(f32)
        placed = t[:, m0] * wx0 + t[:, m1] * wx1             # [RP, RP]
        ys = slice(y0s[k], y0s[k] + RP)
        xs = slice(x0s[k], x0s[k] + RP)
        Tw = canvas[3, ys, xs].to(f32)
        T2 = Tw * placed
        for ch in range(3):
            canvas[ch, ys, xs] = (canvas[ch, ys, xs].to(f32)
                                  + cc[k, ch] * T2).to(cdt)
        canvas[3, ys, xs] = (Tw - T2).to(cdt)
    return canvas


def warp_composite(canvas, P2m, ayf, axf, cc, valid, p: CompositeParams,
                   pdt):
    """Kernel B: OVER of the depth-ordered particles' placed P2 planes
    onto ``canvas`` [4, Hc, Wc] (bf16 or fp32; updated in place and
    returned).  ``P2m`` [N, RM, RM] fp32, ``ayf``/``axf`` [N] fp32 rect
    origins in canvas pixels, ``cc`` [N, 3] fp32 colour factors
    alb*(lcol+amb), ``valid`` [N] int32; ``pdt`` is the placement
    rounding type (the working dtype, fp32 when RM == RP)."""
    dev = canvas.device
    N, RM = p.N, p.RM
    _check(canvas, "canvas", (torch.bfloat16, torch.float32),
           (4, p.Hc, p.Wc))
    _check(P2m, "P2m", (torch.float32,), (N, RM, RM), dev)
    _check(ayf, "ayf", (torch.float32,), (N,), dev)
    _check(axf, "axf", (torch.float32,), (N,), dev)
    _check(cc, "cc", (torch.float32,), (N, 3), dev)
    _check(valid, "valid", (torch.int32,), (N,), dev)
    if pdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"placement dtype {pdt} not supported")
    if dev.type != "cuda":
        return warp_composite_plain(canvas, P2m, ayf, axf, cc, valid, p,
                                    pdt)
    from volq_torch.render._build import load
    fn = load("warp_composite").warp_composite_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int] + [ctypes.c_void_p] * 4 \
        + [CompositeParams, ctypes.c_void_p]
    err = fn(_ptr(canvas), int(canvas.dtype == torch.bfloat16), _ptr(P2m),
             int(pdt == torch.bfloat16), _ptr(ayf), _ptr(axf), _ptr(cc),
             _ptr(valid), p, _stream(dev))
    if err:
        raise RuntimeError(f"warp_composite launch failed: CUDA error {err}")
    warp_composite.launches += 1
    return canvas


warp_composite.launches = 0
