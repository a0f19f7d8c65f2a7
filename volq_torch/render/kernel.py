"""The warp engine's kernels (counterpart of ``volq/render/kernel.py``).

The TPU's fused ``march_warp_pallas`` (every mode over slab banks) is
split where its work stops being per-particle:

* ``warp_march`` (kernel A, ``csrc/warp_march.cu``): per depth-ordered
  particle, the march over its slab stack -- telescoped when unlit or
  center-lit (one more sample of the light slab at step S // 2), the
  OVER recurrence over density and light slabs when per-step lit
  (``light_mode="march"``, steps reversed for particles behind the eye
  plane) --, the fan shift at march resolution and the exps -> P2m
  [N, RM, RM] (unlit) or (P1m, P2m) [N, 2, RM, RM] (lit), fp32, plus
  the shift-clamp count;
* ``warp_composite`` (kernel B, ``csrc/warp_composite.cu``): per canvas
  tile, the hat placement of each covering particle's plane(s) into
  canvas coordinates -- pixels, or the cells of a coarse / scaled canvas
  (``warp_coarse``, ``warp_canvas_scale``) at a fractional origin -- and
  the OVER read-modify-write, in depth order; ``warp_interleave``'s
  association (colour coefficients folded into the x weights) is a mode.

The unfused pair (``warp_fused=False``):

* ``warp_images`` (kernel C, ``csrc/warp_images.cu``): the unfused
  ``march_warp_pallas`` -- A's march, fan and exps, then the RM -> RP hat
  upsample and the RGB expansion into images [N, 4, RP, RP] in the
  working type;
* ``composite_chunk`` (kernel D, ``csrc/composite_chunk.cu``):
  ``composite_chunk_pallas`` -- OVER of one depth-ordered chunk of those
  images onto the legacy canvas.

A and C take both projections: an orthographic camera
(``MarchParams.ortho``) is a compile-time mode of their march, as the
reference's ``persp = False`` branches are of ``march_warp_pallas``.
B and D do not depend on the projection.  A and C run one march
(``csrc/march.cuh``): step-major through a shared-memory ring of slab
stages, in the arm their plans pick from the shapes (``MarchPlan``:
``march_plan``; ``images_plan`` adds the rows a band of C's upsample,
whose buffers alias the ring).  B and D build per-tile lists in their
launch (``csrc/tile_lists.cuh``: ``tile_fill`` / ``chunk_fill``; plain
versions ``tile_lists_plain`` / ``chunk_lists_plain``), order each
tile's list in its block and walk it a warp per sub-tile; their plans
(``composite_plan`` / ``chunk_plan``) size the tile grid and the list
slots.

Each wrapper launches its CUDA kernel for tensors on the card (raising
if it cannot) and runs its plain PyTorch version, ``*_plain``, only for
tensors on the CPU.  The plain versions repeat the kernels' arithmetic
op for op (same rounding points, same fp32 operation order), so on the
card kernels B and D are bit-equal to their plain versions and kernels
A and C equal to them (max abs err 0).  ``launches`` on each wrapper counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from volq_torch._build import (check_tensor as _check, ptr as _ptr,
                               stream as _stream)
from volq_torch.scene.config import SceneConfig

# how far _sign_eps keeps a ray's z component from 0 (the reference's)
_EPS = 1e-6

# per-particle geometry columns of warp_march's ``pgeom`` [N, PG_N]
(PG_LOX, PG_LOY, PG_LOZ, PG_EXT, PG_SCALE, PG_SZN, PG_VALID, PG_SX0,
 PG_SY0, PG_PXC, PG_PYC, PG_N) = range(12)


def _f32(x) -> float:
    """A Python float rounded to fp32 (how JAX uses a weak Python scalar
    in fp32 arithmetic)."""
    return float(np.float32(x))


class CanvasGeom(NamedTuple):
    """Fused-path canvas geometry, field for field the reference's
    ``volq/render/kernel.py:CanvasGeom`` (its array units: x extents in
    lanes when ``ilv``, rows / cells / pixels otherwise).

    ``coarse`` (warp_coarse): the canvas axes are march cells of
    ``1/ratio`` pixels; ``warp_canvas_scale`` gives cells at an arbitrary
    ``ratio``.  A particle's planes land at the fractional cell position
    ``pad + s*ratio`` through 2-tap hat weights, and the finish upsamples
    cells to pixels once per frame.  ``ilv`` (warp_interleave): the TPU
    stores the canvas as [Hc, Wc] lanes, lane = 4*x + channel, and
    de-interleaves it once per frame to [4, Hc, Wc // 4] planes; the
    port's canvas is those planes from the start (``Wx`` columns), and
    ``ilv`` only selects the composite's association.  ``WH`` / ``WW`` /
    ``WWA`` are the TPU window's dims; they size the padding and bound
    what a particle's placement may touch (``warp.placement_boxes``).

      WH, WW, WWA  window rows / x extent / always-copied part of it
      Hc, Wc       canvas array dims
      pad          content origin offset (cells or px)
      hc_img, wc_img  image extent in cells or px (without the padding)
      cu, sup      placed content extent and support (cu + 1 in cells)
      e, gx        array elements per x unit (4 if ilv), window x grain
      ratio        cells per pixel (fp32-exact float), 1.0 on pixels
    """
    WH: int
    WW: int
    WWA: int
    Hc: int
    Wc: int
    pad: int
    hc_img: int
    wc_img: int
    cu: int
    sup: int
    e: int
    gx: int
    ratio: float
    coarse: bool
    ilv: bool

    @property
    def cells(self) -> bool:
        """The canvas axes are cells, not pixels."""
        return self.coarse or self.ratio != 1.0

    @property
    def Wx(self) -> int:
        """Canvas columns in x units (cells or pixels)."""
        return self.Wc // self.e


def canvas_geom(cfg: SceneConfig, h_local: int) -> CanvasGeom:
    from volq_torch.render.warp import march_rect
    r = cfg.render
    RP, RM = r.warp_rect, march_rect(cfg)
    coarse, ilv = bool(r.warp_coarse), bool(r.warp_interleave)
    if coarse or r.warp_canvas_scale:
        if coarse:
            ratio = float(np.float32(RM - 1) / np.float32(RP - 1))
            cu = RM
        else:
            ratio = float(np.float32(r.warp_canvas_scale))
            cu = int(np.ceil((RP - 1) * ratio)) + 1
        sup = cu + 1               # the hat tent leaks past each end
        hc_img = int(np.ceil((h_local - 1) * ratio)) + 1
        wc_img = int(np.ceil((r.width - 1) * ratio)) + 1
        pad = cu                   # |s0| * ratio <= cu - 1 off screen
    else:
        ratio = 1.0
        cu = sup = pad = RP
        hc_img, wc_img = h_local, r.width
    e = 4 if ilv else 1
    gx = 128 // e
    WH = -(-(sup + 8) // 8) * 8
    WW = -(-(e * (gx + sup)) // 128) * 128
    WWA = min(WW, -(-(e * (sup + gx // 2)) // 128) * 128)
    return CanvasGeom(WH, WW, WWA, hc_img + pad + WH,
                      e * (wc_img + pad) + WW, pad, hc_img, wc_img, cu,
                      sup, e, gx, ratio, coarse, ilv)


def cell_to_march(cg: CanvasGeom, RM: int, RP: int) -> float:
    """March cells per canvas cell, the reference's static C2M (fp32;
    exactly 1.0 under warp_coarse)."""
    return float(np.float32((RM - 1) / max(RP - 1, 1))
                 / np.float32(cg.ratio))


def _canvas_dims(cfg: SceneConfig, h_local: int):
    """(WH, WW, Hc, Wc) of the legacy pixel-plane canvas the unfused
    composite uses.  WH / WW are the TPU window dims; they size the
    padding and the clip of the image origins.  For the pixel canvas
    the dims equal ``canvas_geom``'s."""
    r = cfg.render
    RP = r.warp_rect
    WH = RP + 8
    WW = -(-(RP + 128) // 128) * 128
    return WH, WW, h_local + RP + WH, r.width + RP + WW


def canvas_init(cfg: SceneConfig, h_local: int, device,
                fused: bool = True) -> torch.Tensor:
    """Padded canvas [4, Hc, Wx]: C = 0, T = 1, bf16 unless
    warp_canvas_fp32 (plain torch; the TPU version was no kernel).
    ``fused`` picks the layout of the composite that will consume it:
    ``canvas_geom``'s (pixels or cells, always planes) or the unfused
    path's legacy dims."""
    if fused:
        g = canvas_geom(cfg, h_local)
        Hc, Wc = g.Hc, g.Wx
    else:
        _, _, Hc, Wc = _canvas_dims(cfg, h_local)
    cdt = torch.float32 if cfg.render.warp_canvas_fp32 else torch.bfloat16
    c = torch.zeros((4, Hc, Wc), dtype=cdt, device=device)
    c[3] = 1
    return c


# --------------------------------------------------------------------------
# kernel A: warp_march

# MarchParams.lit
UNLIT, CENTER, PERSTEP = 0, 1, 2


class MarchParams(ctypes.Structure):
    """Scalar parameters of the march kernels A and C (mirrors
    ``MarchParams`` in csrc/warp_common.cuh).  ``lit``: ``UNLIT``,
    ``CENTER`` (one light sample at step ``mid``) or ``PERSTEP`` (the
    OVER recurrence over density and light slabs at every step);
    ``RP`` / ``ratio_m``: the rect kernel C upsamples to; ``ortho``: an
    orthographic camera (parallel rays along fwd, ``rx_u`` / ``ry_w``
    the rays' z = 0 intercepts) instead of a perspective one.  The float
    fields are fp32 roundings of the reference's Python-double
    constants."""
    _fields_ = [(n, ctypes.c_int) for n in
                ("N", "S", "VX", "V", "RM", "row_fan", "lit", "mid", "RP",
                 "ortho")] \
        + [(n, ctypes.c_float) for n in
           ("gsc", "gscx", "Sf", "ratio", "Kc", "Kc_hi", "rm_hi", "W", "H",
            "two_over_W", "two_over_H", "ratio_m")]


def _ratio_m(RM: int, RP: int) -> float:
    """Rect pixel -> march cell factor of the hat upsample (fp32)."""
    return float(np.float32(RM - 1) / np.float32(max(RP - 1, 1)))


def march_params(N: int, S: int, VX: int, V: int, RM: int, RP: int,
                 K: int, row_fan: bool, W: int, H: int,
                 lit: int = UNLIT, ortho: bool = False) -> MarchParams:
    ratio = (RP - 1.0) / max(RM - 1, 1)
    Kc = K / ratio
    return MarchParams(
        N=N, S=S, VX=VX, V=V, RM=RM, row_fan=int(row_fan), lit=int(lit),
        mid=S // 2, RP=RP, ortho=int(bool(ortho)),
        gsc=_f32(V - 1), gscx=_f32(VX - 1), Sf=_f32(S), ratio=_f32(ratio),
        Kc=_f32(Kc), Kc_hi=_f32(Kc - 1e-3), rm_hi=_f32(RM - 1.0 - 1e-3),
        W=_f32(W), H=_f32(H), two_over_W=_f32(2.0 / W),
        two_over_H=_f32(2.0 / H), ratio_m=_ratio_m(RM, RP))


def _hat(g, k, n: int, wdt):
    """Hat weight of integer tap k at position g, rounded to the working
    type, 0 where k is outside [0, n)."""
    w = torch.clamp(1.0 - torch.abs(g - k.to(torch.float32)), min=0.0)
    w = w.to(wdt).to(torch.float32)
    return torch.where((k >= 0) & (k < n), w, torch.zeros_like(w))


def _sign_eps(v):
    """v moved away from 0 to +-_EPS (the sign of v; +_EPS for 0)."""
    eps = torch.where(v >= 0, _EPS, -_EPS)
    return torch.where(torch.abs(v) < _EPS, eps, v)


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


def _march_fan_exp_plain(bank, vidx, pgeom, rx_u, ry_w, camf,
                         p: MarchParams, lbank=None):
    """The march, fan and exps kernels A and C share (csrc/march.cuh:
    march_particle), in plain PyTorch with the same arithmetic.  Returns
    (P1m, P2m [N, RM, RM] fp32 -- P1m is P2m when unlit --, clamp count
    [1] int32)."""
    dev = pgeom.device
    f32 = torch.float32
    N, RM, S = p.N, p.RM, p.S
    wdt = bank.dtype
    perstep = p.lit == PERSTEP
    col = lambda c: pgeom[:, c].reshape(N, 1, 1)      # noqa: E731
    lo_x, lo_y, lo_z = col(PG_LOX), col(PG_LOY), col(PG_LOZ)
    ext, scale, szn = col(PG_EXT), col(PG_SCALE), col(PG_SZN)
    valid = col(PG_VALID) > 0
    eye_x, eye_y, eye_z = camf[0], camf[1], camf[2]
    rx = rx_u[:, None, :]                               # [N, 1, RM] (i)
    ry = ry_w[:, :, None]                               # [N, RM, 1] (j)

    fwd_x, fwd_y, fwd_z = camf[9], camf[10], camf[11]
    Sf = torch.tensor(p.Sf, dtype=f32, device=dev)

    # ray/AABB: geo = scale * min(dt_raw, seg).  Perspective: rays from
    # the eye along (rx, ry, 1) * szn.  Orthographic: rays along fwd from
    # (rx + eye_z*kx, ry + eye_z*ky, eye_z), kx = fwd_x / fwd_z
    if p.ortho:
        fz_s = _sign_eps(fwd_z)
        kx, ky = fwd_x / fz_s, fwd_y / fz_s
        o_x, o_y, o_z = rx + eye_z * kx, ry + eye_z * ky, eye_z
        d_x, d_y, d_z = fwd_x, fwd_y, fwd_z
        dt_raw = ext / Sf / torch.abs(fz_s)
    else:
        rnorm = torch.sqrt(rx * rx + ry * ry + 1.0)
        inv_n = torch.ones_like(rnorm) / rnorm
        o_x, o_y, o_z = eye_x, eye_y, eye_z
        d_x = rx * inv_n * szn
        d_y = ry * inv_n * szn
        d_z = inv_n * szn
        dt_raw = (ext / Sf) * rnorm
    t0x, t1x = _axis_seg(o_x, d_x, lo_x, lo_x + ext)
    t0y, t1y = _axis_seg(o_y, d_y, lo_y, lo_y + ext)
    t0z, t1z = _axis_seg(o_z, d_z, lo_z, lo_z + ext)
    t0 = torch.maximum(torch.maximum(t0x, t0y), torch.clamp(t0z, min=0.0))
    t1 = torch.minimum(torch.minimum(t1x, t1y), t1z)
    seg = torch.clamp(t1 - t0, min=0.0)
    geo = scale * torch.minimum(dt_raw, seg)

    # march.  Telescoped (unlit, center-lit): od = sum_s sum_{a taps}
    # rnd(t1[a]) * wx[a], ascending steps.  Per-step lit: both stacks
    # sampled at every step and the OVER recurrence on (P1, T), the
    # steps reversed for particles with szn < 0 (front to back).
    kx2 = torch.tensor(p.gscx, dtype=f32, device=dev) / ext
    ky2 = torch.tensor(p.gsc, dtype=f32, device=dev) / ext
    if p.ortho:
        rxk, ryk = kx2 * rx, ky2 * ry
    else:
        bx_h = (eye_x - lo_x) * kx2
        by_h = (eye_y - lo_y) * ky2
    stacks = bank[vidx.long()]                          # [N, S, VX, V]
    n_idx = torch.arange(N, device=dev).reshape(N, 1, 1)
    zero = torch.zeros((N, RM, RM), dtype=f32, device=dev)
    od, tau = zero, zero
    if perstep:
        lstacks = lbank[vidx.long()]
        flip = szn < 0
        n_flat = n_idx.reshape(N)
        se = scale * ext
        P1, T = zero, torch.ones_like(zero)
    for si in range(S):
        if perstep:
            s_n = torch.where(flip, S - 1 - si, si)     # [N, 1, 1]
            zeta = (s_n.to(f32) + 0.5) / Sf
        else:
            zeta = float(np.float32(np.float32(si) + np.float32(0.5))
                         / np.float32(p.Sf))
        zw = lo_z + zeta * ext
        if p.ortho:
            gx = (zw * kx - lo_x) * kx2 + rxk
            gy = (zw * ky - lo_y) * ky2 + ryk
        else:
            c1 = zw - eye_z
            gx = bx_h + (c1 * kx2) * rx                 # [N, 1, RM]
            gy = by_h + (c1 * ky2) * ry                 # [N, RM, 1]
        tpos = (zw - eye_z) * szn > 0
        gyc = torch.where((gy >= 0) & (gy <= p.gsc) & tpos, gy, -2.0)
        gxc = torch.where((gx >= 0) & (gx <= p.gscx), gx, -2.0)
        b0 = torch.floor(gyc).to(torch.int64)
        a0 = torch.floor(gxc).to(torch.int64)
        wy0, wy1 = _hat(gyc, b0, p.V, wdt), _hat(gyc, b0 + 1, p.V, wdt)
        wx0, wx1 = _hat(gxc, a0, p.VX, wdt), _hat(gxc, a0 + 1, p.VX, wdt)

        def sample(slab, acc):
            """acc + sum over the x taps of rnd(Wy . slab[a]) * wx."""
            def tap(a, b):
                a = a.clamp(0, p.VX - 1).expand(N, RM, RM)
                b = b.clamp(0, p.V - 1).expand(N, RM, RM)
                return slab[n_idx, a, b].to(f32)

            for a, wx in ((a0, wx0), (a0 + 1, wx1)):
                t1v = wy0 * tap(a, b0) + wy1 * tap(a, b0 + 1)
                acc = acc + t1v.to(wdt).to(f32) * wx
            return acc

        if perstep:
            s_flat = s_n.reshape(N)
            sig = sample(stacks[n_flat, s_flat], zero)
            tau_s = sample(lstacks[n_flat, s_flat], zero)
            alpha = 1.0 - torch.exp(-sig * geo)
            atten = torch.exp(-se * torch.clamp(tau_s, min=0.0))
            fa = T * alpha
            P1 = P1 + fa * atten
            T = T - fa
            continue
        od = sample(stacks[:, si], od)                  # slab [N, VX, V]
        if p.lit == CENTER and si == p.mid:
            # center-lit: one light sample, this step's masked weights
            tau = sample(lbank[vidx.long(), si], tau)

    # fan shift (closed form of render/warp.fan_shifts), column pass
    g1 = lambda c: pgeom[:, c].reshape(N, 1, 1)         # noqa: E731
    sx0, sy0, pxc, pyc = g1(PG_SX0), g1(PG_SY0), g1(PG_PXC), g1(PG_PYC)
    rxc, ryc, rzc = camf[3], camf[4], camf[5]
    uxc, uyc, uzc = camf[6], camf[7], camf[8]
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
    dox_i = ((sx0 + iv + 0.5) - pxc) * dxk              # [N, 1, RM(i)]
    if p.ortho:
        # rx is affine in the pixel: a constant ratio per row (column)
        du = _safe_div(doy_j * (uxc - uzc * kx), dox_step * (rxc - rzc * kx))
        du = du.expand(N, RM, RM)
    else:
        ox_i = ((sx0 + iv + 0.5) * p.two_over_W - 1.0) * sxs
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
    dw = None
    if p.row_fan and p.ortho:
        dw = _safe_div(dox_i * (ryc - rzc * ky), doy_step * (uyc - uzc * ky))
        dw = dw.expand(N, RM, RM)
    elif p.row_fan:
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
    if dw is not None:
        clamped_y = ((dw < -p.Kc) | (dw > p.Kc_hi)) & valid
        dw = torch.clamp(dw, -p.Kc, p.Kc_hi)
        dw = torch.maximum(dw, -jj)
        dw = torch.minimum(dw, p.rm_hi - jj)
        n_clamp = n_clamp + clamped_y.sum()

    def fan(x):
        x = _shift(x, du, ii.expand_as(du), 2)
        return x if dw is None else _shift(x, dw, jj.expand_as(dw), 1)

    if perstep:
        # P2 = 1 - T; both planes go through the fan, no exp after it
        P1m, P2m = fan(P1), fan(1.0 - T)
        P1m = torch.where(valid, P1m, zero)
    else:
        P2m = 1.0 - torch.exp(-fan(od * geo))
    P2m = torch.where(valid, P2m, zero)
    if p.lit == UNLIT:
        P1m = P2m
    elif p.lit == CENTER:
        # the tau plane bypasses the fan: atten = exp(-tau') per ray
        taup = (scale * ext) * torch.clamp(tau, min=0.0)
        P1m = torch.exp(-taup) * P2m
    return P1m, P2m, n_clamp.to(torch.int32).reshape(1)


def warp_march_plain(bank, vidx, pgeom, rx_u, ry_w, camf, p: MarchParams,
                     lbank=None):
    """Plain PyTorch version of kernel A (same arithmetic).  Returns
    (P2m [N, RM, RM] -- lit: (P1m, P2m) [N, 2, RM, RM] -- fp32, clamp
    count [1] int32)."""
    P1m, P2m, clamp = _march_fan_exp_plain(bank, vidx, pgeom, rx_u, ry_w,
                                           camf, p, lbank)
    return (torch.stack([P1m, P2m], dim=1) if p.lit else P2m), clamp


# the shared memory a block may opt into on an H100 (227 KB), and its SMs
SMEM_OPTIN = 232448
SMEM_SM = 233472         # an SM's 228 KB
N_SM = 132
MARCH_CAP = 20           # rays a thread of kernel A at most
MARCH_BLOCK = 1024
MAX_STAGES = 4


class MarchPlan(ctypes.Structure):
    """How kernel A or C runs a launch (mirrors ``MarchPlan`` in
    csrc/march.cuh): ``G`` column groups (a block of RM * G threads; a
    thread marches row t % RM at columns t // RM + c * G, at most
    ``MARCH_CAP``), ``stages`` of the shared-memory slab ring (0: the
    global arm, taps read from device memory), ``smem`` dynamic shared
    bytes, ``band`` the output rows a round of C's y pass (0 for A, and
    for C where RM == RP)."""
    _fields_ = [(n, ctypes.c_int) for n in ("G", "stages", "smem", "band")]

    @property
    def arm(self) -> str:
        return f"staged x{self.stages}" if self.stages else "global"


def _march_prefix(p: MarchParams, stages: int, itemsize: int) -> int:
    """Shared bytes of the march before its plane: (staged) the ring of
    ``stages`` slab stages (per-step lit: density and light slab) and
    center-lit's light slab, then the column tables [2, RM] float4."""
    slab = p.VX * p.V * itemsize
    b = 2 * p.RM * 16
    if stages:
        b += stages * slab * (2 if p.lit == PERSTEP else 1)
        b += slab if p.lit == CENTER else 0
    return b


def _march_tail(p: MarchParams) -> int:
    """Shared bytes from the plane on: the plane [RM, RM | 1] and rx / ry
    [2, RM] fp32."""
    return (p.RM * (p.RM | 1) + 2 * p.RM) * 4


def march_smem(p: MarchParams, stages: int, itemsize: int) -> int:
    """Dynamic shared bytes of kernel A (csrc/march.cuh's layout)."""
    return _march_prefix(p, stages, itemsize) + _march_tail(p)


def images_smem(p: MarchParams, stages: int, itemsize: int,
                band: int) -> int:
    """Dynamic shared bytes of kernel C: A's, with the P1 plane [RM, RM |
    1] (lit) and the y-pass rows [NPL, band, RM] fp32 of its epilogue in
    place of the ring and column tables, where they are the larger."""
    npl = 2 if p.lit else 1
    epi = ((p.RM * (p.RM | 1) if p.lit else 0) + npl * band * p.RM) * 4
    return max(_march_prefix(p, stages, itemsize), epi) + _march_tail(p)


def march_plan(p: MarchParams, itemsize: int,
               aligned: bool = True) -> MarchPlan:
    """Kernel A's plan for these shapes: ``itemsize`` of the bank (2
    bf16, 4 fp32), ``aligned`` whether the banks start on 16 bytes.
    The fewest threads a block (the most rays a thread) that
    ``MARCH_CAP`` allows -- more, smaller blocks an SM wait less on each
    other's step barriers -- or, with fewer particles than SMs, halfway
    to the most RM allows.  The staged arm with as many stages (2-4,
    at most S) as leave the SM as many blocks as its registers allow
    (else two stages, if they fit ``SMEM_OPTIN``), else the global arm
    (also for a slab that is not a whole number of 16-byte copies)."""
    # a copy: the cached plan stays as computed whatever a caller does
    return MarchPlan.from_buffer_copy(
        _march_plan(_key(p), itemsize, bool(aligned)))


def _sm_room(RM: int, G: int) -> int:
    """Shared bytes each block may take and still leave an SM the blocks
    of RM * G threads it holds at the march's 64 registers a thread (1 KB
    a block reserved)."""
    blocks = max(1, 65536 // (RM * G * 64))
    return min(SMEM_OPTIN, SMEM_SM // blocks - 1024)


@functools.lru_cache(maxsize=64)
def _march_plan(key: bytes, itemsize: int, aligned: bool) -> MarchPlan:
    p = MarchParams.from_buffer_copy(key)
    RM = p.RM
    g_min, g_max = -(-RM // MARCH_CAP), MARCH_BLOCK // max(RM, 1)
    if RM < 1 or RM > 128:
        raise ValueError(f"march rect {RM} not supported (1 to 128)")
    G = (g_min + g_max) // 2 if p.N < N_SM else g_min
    stages = 0
    if aligned and (p.VX * p.V * itemsize) % 16 == 0:
        room = _sm_room(RM, G)
        fits = [D for D in range(2, min(MAX_STAGES, p.S) + 1)
                if march_smem(p, D, itemsize) <= SMEM_OPTIN]
        share = [D for D in fits if march_smem(p, D, itemsize) <= room]
        stages = max(share or fits[:1] or [0])
    smem = march_smem(p, stages, itemsize)
    if smem > SMEM_OPTIN:
        raise ValueError(f"march rect {RM} needs {smem} B of shared memory")
    return MarchPlan(G=G, stages=stages, smem=smem)


def images_plan(p: MarchParams, itemsize: int,
                aligned: bool = True) -> MarchPlan:
    """Kernel C's plan for these shapes: kernel A's block width and ring
    (``march_plan``), and the output rows a band of its y pass: none where
    RM == RP (the identity), else the most, up to RP and spread evenly
    over the bands, whose buffers -- the P1 plane and the y-pass rows,
    aliasing the ring -- keep C's shared bytes within what leaves an SM
    the blocks A's plan holds (or within A's own, where that is more);
    failing that, within the 227 KB a block may opt into."""
    # a copy: the cached plan stays as computed whatever a caller does
    return MarchPlan.from_buffer_copy(
        _images_plan(_key(p), itemsize, bool(aligned)))


@functools.lru_cache(maxsize=64)
def _images_plan(key: bytes, itemsize: int, aligned: bool) -> MarchPlan:
    p = MarchParams.from_buffer_copy(key)
    a = _march_plan(key, itemsize, aligned)
    band = 0
    if p.RM != p.RP:
        row = (2 if p.lit else 1) * p.RM * 4
        fixed = _march_tail(p) + (p.RM * (p.RM | 1) * 4 if p.lit else 0)
        for limit in (max(_sm_room(p.RM, a.G), a.smem), SMEM_OPTIN):
            band = min(p.RP, (limit - fixed) // row)
            if band >= 1:
                break
        if band < 1:
            raise ValueError(f"rect {p.RP} at march rect {p.RM}: no y-pass "
                             "row fits the shared memory")
        band = -(-p.RP // -(-p.RP // band))
    smem = images_smem(p, a.stages, itemsize, band)
    if smem > SMEM_OPTIN:
        raise ValueError(f"rect {p.RP} at march rect {p.RM} needs {smem} B "
                         "of shared memory")
    return MarchPlan(G=a.G, stages=a.stages, smem=smem, band=band)


def _key(s: ctypes.Structure) -> bytes:
    """A parameter struct's bytes, as a cache key."""
    return bytes(s)


def _kernel_fn(lib: str, name: str, argtypes):
    """C function ``name`` of kernel library ``lib`` (built at first
    use), with its argument types set."""
    from volq_torch._build import load
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _check_march(bank, vidx, pgeom, rx_u, ry_w, camf, p: MarchParams,
                 lbank):
    dev = pgeom.device
    N, RM = p.N, p.RM
    _check(bank, "bank", (torch.bfloat16, torch.float32),
           (bank.shape[0], p.S, p.VX, p.V), dev)
    if p.lit:
        if lbank is None:
            raise ValueError("a lit march needs the light slab bank")
        _check(lbank, "lbank", (bank.dtype,), tuple(bank.shape), dev)
    elif lbank is not None:
        raise ValueError("light slab bank given to an unlit march")
    _check(vidx, "vidx", (torch.int32,), (N,), dev)
    _check(pgeom, "pgeom", (torch.float32,), (N, PG_N), dev)
    _check(rx_u, "rx_u", (torch.float32,), (N, RM), dev)
    _check(ry_w, "ry_w", (torch.float32,), (N, RM), dev)
    _check(camf, "camf", (torch.float32,), (16,), dev)
    return dev


_MARCH_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] \
    + [ctypes.c_void_p] * 7 + [MarchParams, MarchPlan, ctypes.c_void_p]


def warp_march(bank, vidx, pgeom, rx_u, ry_w, camf, p: MarchParams,
               lbank=None, plan: MarchPlan | None = None):
    """Kernel A: march + fan + exp of the depth-ordered particles.
    ``bank`` [M, S, VX, V] (bf16 or fp32 slab bank), ``vidx`` [N] int32,
    ``pgeom`` [N, PG_N] fp32, ``rx_u``/``ry_w`` [N, RM] fp32, ``camf``
    [16] fp32 (eye, right, up, fwd, scale_x, scale_y), ``lbank`` the
    light slab bank (shape and type of ``bank``) when ``p.lit``:
    ``CENTER`` reads its slab ``p.mid`` only, ``PERSTEP`` every slab,
    walking the steps back to front for particles with szn < 0
    (``pgeom[:, PG_SZN]``) so one front-to-back recurrence serves all.
    ``plan``: the launch's arm and sizes (default ``march_plan`` of these
    shapes; a plan the kernel cannot take raises).
    Returns (P2m [N, RM, RM] -- lit: (P1m, P2m) [N, 2, RM, RM] -- fp32,
    clamp count [1] int32)."""
    dev = _check_march(bank, vidx, pgeom, rx_u, ry_w, camf, p, lbank)
    if dev.type != "cuda":
        return warp_march_plain(bank, vidx, pgeom, rx_u, ry_w, camf, p,
                                lbank)
    fn = _kernel_fn("warp_march", "warp_march_launch", _MARCH_ARGS)
    if plan is None:
        aligned = all(t.data_ptr() % 16 == 0 for t in (bank, lbank)
                      if t is not None)
        plan = march_plan(p, bank.element_size(), aligned)
    N, RM = p.N, p.RM
    Pm = torch.empty((N, 2, RM, RM) if p.lit else (N, RM, RM),
                     dtype=torch.float32, device=dev)
    clamp = torch.zeros((1,), dtype=torch.int32, device=dev)
    err = fn(_ptr(bank), _ptr(lbank), int(bank.dtype == torch.bfloat16),
             _ptr(vidx), _ptr(pgeom), _ptr(rx_u), _ptr(ry_w), _ptr(camf),
             _ptr(Pm), _ptr(clamp), p, plan, _stream(dev))
    if err:
        raise RuntimeError(f"warp_march launch failed: CUDA error {err}")
    warp_march.launches += 1
    return Pm, clamp


warp_march.launches = 0


# --------------------------------------------------------------------------
# kernel B: warp_composite

class CompositeParams(ctypes.Structure):
    """Mirrors ``CompositeParams`` in csrc/warp_composite.cu.  ``Wc`` is
    the canvas width in x units (``CanvasGeom.Wx``); ``gscale`` maps a
    canvas offset from the placement origin to march cells: the rect
    pixel -> march cell factor on a pixel canvas, the reference's C2M on
    a cell canvas."""
    _fields_ = [(n, ctypes.c_int)
                for n in ("N", "RM", "Hc", "Wc", "lit", "ilv")] \
        + [("gscale", ctypes.c_float)]


def composite_params(N: int, RM: int, Hc: int, Wc: int, gscale: float,
                     lit: bool = False, ilv: bool = False) -> CompositeParams:
    return CompositeParams(N=N, RM=RM, Hc=Hc, Wc=Wc, lit=int(bool(lit)),
                           ilv=int(ilv), gscale=_f32(gscale))


# the canvas tile of kernels B and D (csrc/tile_lists.cuh)
TILE_H, TILE_W = 16, 64


class CompositePlan(ctypes.Structure):
    """How kernel B or D runs a launch (mirrors ``TilePlan`` in
    csrc/tile_lists.cuh): the ``ntx`` x ``nty`` grid of TILE_H x TILE_W
    tiles and ``capt`` list slots a tile."""
    _fields_ = [(n, ctypes.c_int) for n in ("ntx", "nty", "capt")]


def _tile_plan(N: int, Hc: int, Wc: int, ext: int | None) -> CompositePlan:
    """The tile grid over an [Hc, Wc] canvas and its list slots for N
    rects of at most ``ext`` x ``ext`` cells (None: unbounded): 8x the
    list a tile would have on average if every rect met as many tiles as
    the largest can, at least 256 and at most N."""
    ntx, nty = -(-Wc // TILE_W), -(-Hc // TILE_H)
    nt = ntx * nty
    per = nt
    if ext is not None:
        per = min(per, (-(-(ext - 1) // TILE_H) + 1)
                  * (-(-(ext - 1) // TILE_W) + 1))
    capt = min(N, max(256, -(-8 * N * per // nt)))
    if 2 * nt * capt >= 2 ** 31:
        raise ValueError(f"{N} rects on {nt} tiles need too many list "
                         "slots")
    return CompositePlan(ntx=ntx, nty=nty, capt=capt)


@functools.lru_cache(maxsize=64)
def _composite_plan(key: bytes) -> CompositePlan:
    p = CompositeParams.from_buffer_copy(key)
    g = float(p.gscale)
    ext = None
    if g > 0:
        ext = int(np.ceil((p.RM - 1) / g)) + 4 + 2 * int(np.ceil(1 / g))
    return _tile_plan(p.N, p.Hc, p.Wc, ext)


def composite_plan(p: CompositeParams) -> CompositePlan:
    """Kernel B's plan for these shapes (``_tile_plan``), the largest box
    its placed extent ceil((RM-1)/gscale) + 1, the tent's leak
    ceil(1/gscale) past each end, the cell canvas's support cell and one
    of slack; where a list does not fit, the tile's warps test every
    particle."""
    # a copy: the cached plan stays as computed whatever a caller does
    return CompositePlan.from_buffer_copy(_composite_plan(_key(p)))


def tile_lists_plain(box, valid, Hc: int, Wc: int):
    """Plain PyTorch version of kernel B's per-tile lists: tile t = ty *
    ntx + tx of the TILE_H x TILE_W grid over the [Hc, Wc] canvas lists,
    in ascending order, the valid particles whose non-empty box [y0, y1)
    x [x0, x1) meets it.  Returns (offs [ntiles + 1] int32, lists
    [offs[-1]] int32): tile t's list is lists[offs[t]:offs[t + 1]].  For
    tests; the card builds and orders the lists inside
    ``warp_composite``."""
    dev = box.device
    ntx, nty = -(-Wc // TILE_W), -(-Hc // TILE_H)
    b = box.to(torch.int64)
    fd = lambda a, d: torch.div(a, d, rounding_mode="floor")  # noqa: E731
    y0 = fd(b[:, 0], TILE_H).clamp(min=0)
    y1 = fd(b[:, 1] - 1, TILE_H).clamp(max=nty - 1)
    x0 = fd(b[:, 2], TILE_W).clamp(min=0)
    x1 = fd(b[:, 3] - 1, TILE_W).clamp(max=ntx - 1)
    ok = ((valid != 0) & (b[:, 1] > b[:, 0]) & (b[:, 3] > b[:, 2])
          & (y0 <= y1) & (x0 <= x1))
    k = torch.nonzero(ok).flatten()
    ny, nx = (y1 - y0 + 1)[k], (x1 - x0 + 1)[k]
    cnt = ny * nx
    kk = torch.repeat_interleave(k, cnt)
    first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    q = torch.arange(kk.numel(), device=dev) - first
    nxk = torch.repeat_interleave(nx, cnt)
    t = (y0[kk] + q // nxk) * ntx + x0[kk] + q % nxk
    order = torch.argsort(t * max(box.shape[0], 1) + kk)
    counts = torch.bincount(t, minlength=ntx * nty)
    offs = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return offs.to(torch.int32), kk[order].to(torch.int32)


_COMPOSITE_ARGS = {
    "warp_composite_launch":
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 6 + [CompositeParams, CompositePlan]
        + [ctypes.c_void_p] * 2,
    "warp_composite_fill":
        [ctypes.c_void_p] * 2 + [CompositeParams, CompositePlan]
        + [ctypes.c_void_p] * 2}


def _slots_plain(offs, lists, plan: CompositePlan):
    """Plain lists (offs, lists) in the fill kernels' layout: (counts
    [ntiles], slots [ntiles, capt]) with each tile's first capt entries,
    in order."""
    nt = plan.ntx * plan.nty
    counts = offs[1:] - offs[:-1]
    slots = torch.zeros((nt, plan.capt), dtype=torch.int32)
    for t, (a, b) in enumerate(zip(offs[:-1].tolist(), offs[1:].tolist())):
        n = min(b - a, plan.capt)
        slots[t, :n] = lists[a:a + n]
    return counts, slots


def _list_scratch(plan: CompositePlan, dev) -> torch.Tensor:
    """Kernel B's or D's list scratch: the tiles' counts [ntiles], then
    their slots, as filled [ntiles, capt] and ordered [ntiles, capt] (a
    list longer than the block holds in shared memory), int32."""
    nt = plan.ntx * plan.nty
    return torch.empty(nt * (1 + 2 * plan.capt), dtype=torch.int32,
                       device=dev)


def tile_fill(box, valid, p: CompositeParams,
              plan: CompositePlan | None = None):
    """The first kernel of kernel B's launch alone, for tests and for
    timing that part of B: each valid particle with a non-empty box
    appended to the slots of every tile its box meets.  Returns (counts
    [ntiles] int32, slots [ntiles, capt] int32): tile t's list has
    counts[t] particles, of which slots[t, :min(counts[t], capt)] hold
    the first to arrive, in no order (a longer list did not fit: B tests
    every particle on that tile).  On the CPU: ``tile_lists_plain``'s
    lists in that layout, in order."""
    dev = box.device
    _check(box, "box", (torch.int32,), (p.N, 4))
    _check(valid, "valid", (torch.int32,), (p.N,), dev)
    plan = composite_plan(p) if plan is None else plan
    nt = plan.ntx * plan.nty
    if dev.type != "cuda":
        return _slots_plain(*tile_lists_plain(box, valid, p.Hc, p.Wc), plan)
    scratch = _list_scratch(plan, dev)
    err = _kernel_fn("warp_composite", "warp_composite_fill",
                     _COMPOSITE_ARGS["warp_composite_fill"])(
        _ptr(box), _ptr(valid), p, plan, _ptr(scratch), _stream(dev))
    if err:
        raise RuntimeError(f"tile fill launch failed: CUDA error {err}")
    tile_fill.launches += 1
    return scratch[:nt], scratch[nt:nt * (1 + plan.capt)].view(nt, plan.capt)


tile_fill.launches = 0


def _taps(g, n: int, pdt):
    """Two hat taps (floor, floor + 1) of positions g on [0, n)."""
    k0 = torch.floor(g).to(torch.int64)
    return k0, _hat(g, k0, n, pdt), _hat(g, k0 + 1, n, pdt)


def _place_y(P, gy, pdt):
    """y pass of the hat placement: planes P [..., RM, RM] fp32 rounded
    to ``pdt``, rows sampled at march positions gy [h], the two products
    summed in fp32 and rounded to ``pdt`` -> [..., h, RM].  A tap outside
    the plane has weight 0."""
    RM = P.shape[-1]
    k0, w0, w1 = _taps(gy, RM, pdt)
    ka, kb = k0.clamp(0, RM - 1), (k0 + 1).clamp(0, RM - 1)
    P = P.to(pdt).to(torch.float32)
    t = w0[:, None] * P[..., ka, :] + w1[:, None] * P[..., kb, :]
    return t.to(pdt).to(torch.float32)


def _place_x(t, gx, pdt):
    """x pass: t [..., h, RM] sampled at march positions gx [w], weights
    rounded to ``pdt``, summed in fp32 -> [..., h, w]."""
    RM = t.shape[-1]
    m0, v0, v1 = _taps(gx, RM, pdt)
    ma, mb = m0.clamp(0, RM - 1), (m0 + 1).clamp(0, RM - 1)
    return t[..., ma] * v0 + t[..., mb] * v1


def _upsample_plain(P, RP: int, ratio_m: float, pdt):
    """Hat upsample of planes P [..., RM, RM] fp32 to [..., RP, RP]:
    the plane rounded to ``pdt``, the y pass summed in fp32 and rounded
    to ``pdt``, the x pass summed in fp32 (each weight row has two
    non-zero taps; the reference spells both passes as matmuls)."""
    pos = torch.arange(RP, dtype=torch.float32, device=P.device) * ratio_m
    return _place_x(_place_y(P, pos, pdt), pos, pdt)


def warp_composite_plain(canvas, Pm, ayf, axf, box, cc, valid,
                         p: CompositeParams, pdt, cc2=None):
    """Plain PyTorch version of kernel B: particle by particle in depth
    order, its plane(s) placed over its box of the canvas and the OVER
    RMW (canvas updated in place and returned).

    Canvas cell (y, x) samples the planes at march position
    ``(f32(y) - ayf) * gscale`` (x alike).  The reference forms that
    offset against its 8- (128-) aligned window corner o as
    ``iww - (ayf - o)`` with y = o + iww; both give one fp32 value:
    ayf - o is exact (o is an integer in [0, ayf], so the difference is
    a multiple of ayf's ulp and no larger than ayf), hence both are the
    single rounding of the real number y - ayf."""
    f32 = torch.float32
    cdt = canvas.dtype
    dev = canvas.device
    rnd = lambda a: a.to(pdt).to(f32)                 # noqa: E731
    keep = valid.to(torch.bool).tolist()
    boxes = box.tolist()
    npl = 2 if p.lit else 1
    for k in range(p.N):
        y0, y1, x0, x1 = boxes[k]
        if not keep[k] or y1 <= y0 or x1 <= x0:
            continue
        gy = (torch.arange(y0, y1, dtype=f32, device=dev) - ayf[k]) * p.gscale
        gx = (torch.arange(x0, x1, dtype=f32, device=dev) - axf[k]) * p.gscale
        t = _place_y(Pm[k].reshape(npl, p.RM, p.RM), gy, pdt)
        ys, xs = slice(y0, y1), slice(x0, x1)
        Tw = canvas[3, ys, xs].to(f32)
        if p.ilv:
            # colour coefficients folded into the unrounded x hats, the
            # product rounded to pdt: W[m, c] = pdt(hat[m] * A[c]); then
            # U[c] = sum over the P1 taps, then the P2 taps, in fp32
            m0 = torch.floor(gx).to(torch.int64)
            ma, mb = m0.clamp(0, p.RM - 1), (m0 + 1).clamp(0, p.RM - 1)
            h0, h1 = _hat(gx, m0, p.RM, f32), _hat(gx, m0 + 1, p.RM, f32)
            minus1 = torch.full((), -1.0, dtype=f32, device=dev)
            for ch in range(4):
                if p.lit:
                    A1 = cc[k, ch] if ch < 3 else torch.zeros_like(minus1)
                    A2 = cc2[k, ch] if ch < 3 else minus1
                    U = ((t[0][:, ma] * rnd(h0 * A1)
                          + t[0][:, mb] * rnd(h1 * A1))
                         + t[1][:, ma] * rnd(h0 * A2)) \
                        + t[1][:, mb] * rnd(h1 * A2)
                else:
                    A = cc[k, ch] if ch < 3 else minus1
                    U = t[0][:, ma] * rnd(h0 * A) + t[0][:, mb] * rnd(h1 * A)
                canvas[ch, ys, xs] = (canvas[ch, ys, xs].to(f32)
                                      + Tw * U).to(cdt)
            continue
        placed = _place_x(t, gx, pdt)
        T2 = Tw * placed[-1]
        if p.lit:
            T1 = Tw * placed[0]
        for ch in range(3):
            upd = (cc[k, ch] * T1 + cc2[k, ch] * T2 if p.lit
                   else cc[k, ch] * T2)
            canvas[ch, ys, xs] = (canvas[ch, ys, xs].to(f32) + upd).to(cdt)
        canvas[3, ys, xs] = (Tw - T2).to(cdt)
    return canvas


def warp_composite(canvas, Pm, ayf, axf, box, cc, valid,
                   p: CompositeParams, pdt, cc2=None,
                   plan: CompositePlan | None = None):
    """Kernel B: OVER of the depth-ordered particles' placed planes onto
    ``canvas`` [4, Hc, Wc] (bf16 or fp32; pixels or cells; updated in
    place and returned).  ``Pm`` fp32: P2m [N, RM, RM] unlit, (P1m, P2m)
    [N, 2, RM, RM] when ``p.lit``; ``ayf``/``axf`` [N] fp32 placement
    origins in canvas units (fractional on a cell canvas); ``box``
    [N, 4] int32 (y0, y1, x0, x1): the canvas cells the particle may
    touch (``warp.placement_boxes``); ``cc`` [N, 3] fp32 colour factors:
    alb*(lcol+amb) unlit, alb*lcol lit with ``cc2`` = alb*amb; ``valid``
    [N] int32; ``pdt`` is the placement rounding type (the working
    dtype; fp32 for RM == RP on a pixel canvas).  ``p.ilv`` selects
    ``warp_interleave``'s association: the colour factors (and -1 for
    T) multiply the x hat weights before these are rounded, and all four
    channels update as ``cdt(c + Tw * U)``.  The per-pixel walk follows
    the list's order; the reference's pair and hazard reorders only swap
    depth-adjacent particles whose canvas windows are disjoint, so they
    change no pixel's order and have no counterpart here.  ``plan``: the
    launch's tile grid and list slots (default ``composite_plan`` of
    these shapes; a plan the kernel cannot take raises).  One counted
    launch is two kernels: the lists' fill (``tile_fill``) and the
    composite, which orders each tile's list and walks it."""
    dev = canvas.device
    N, RM = p.N, p.RM
    _check(canvas, "canvas", (torch.bfloat16, torch.float32),
           (4, p.Hc, p.Wc))
    _check(Pm, "Pm", (torch.float32,),
           (N, 2, RM, RM) if p.lit else (N, RM, RM), dev)
    _check(ayf, "ayf", (torch.float32,), (N,), dev)
    _check(axf, "axf", (torch.float32,), (N,), dev)
    _check(box, "box", (torch.int32,), (N, 4), dev)
    _check(cc, "cc", (torch.float32,), (N, 3), dev)
    if p.lit:
        if cc2 is None:
            raise ValueError("a lit composite needs cc2 (alb * ambient)")
        _check(cc2, "cc2", (torch.float32,), (N, 3), dev)
    elif cc2 is not None:
        raise ValueError("cc2 given to an unlit composite")
    _check(valid, "valid", (torch.int32,), (N,), dev)
    if pdt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"placement dtype {pdt} not supported")
    if dev.type != "cuda":
        return warp_composite_plain(canvas, Pm, ayf, axf, box, cc, valid,
                                    p, pdt, cc2)
    if plan is None:
        plan = composite_plan(p)
    scratch = _list_scratch(plan, dev)
    err = _kernel_fn("warp_composite", "warp_composite_launch",
                     _COMPOSITE_ARGS["warp_composite_launch"])(
        _ptr(canvas), int(canvas.dtype == torch.bfloat16), _ptr(Pm),
        int(pdt == torch.bfloat16), _ptr(ayf), _ptr(axf), _ptr(box),
        _ptr(cc), _ptr(cc2), _ptr(valid), p, plan, _ptr(scratch),
        _stream(dev))
    if err:
        raise RuntimeError(f"warp_composite launch failed: CUDA error {err}")
    warp_composite.launches += 1
    return canvas


warp_composite.launches = 0


# --------------------------------------------------------------------------
# kernel C: warp_images

def warp_images_plain(bank, vidx, pgeom, rx_u, ry_w, camf, p: MarchParams,
                      alb, lightf, lbank=None):
    """Plain PyTorch version of kernel C (same arithmetic).  Returns
    (images [N, 4, RP, RP] in the bank's type, clamp count [1] int32)."""
    wdt = bank.dtype
    P1, P2, clamp = _march_fan_exp_plain(bank, vidx, pgeom, rx_u, ry_w,
                                         camf, p, lbank)
    if p.RM != p.RP:
        P2 = _upsample_plain(P2, p.RP, p.ratio_m, wdt)
        P1 = _upsample_plain(P1, p.RP, p.ratio_m, wdt) if p.lit else P2
    a = alb.reshape(p.N, 3, 1, 1)
    lcol = lightf[0:3].reshape(1, 3, 1, 1)
    amb = lightf[3:6].reshape(1, 3, 1, 1)
    rgb = a * (lcol * P1[:, None] + amb * P2[:, None])
    return torch.cat([rgb, (1.0 - P2)[:, None]], dim=1).to(wdt), clamp


_IMAGES_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] \
    + [ctypes.c_void_p] * 9 + [MarchParams, MarchPlan, ctypes.c_void_p]


def warp_images(bank, vidx, pgeom, rx_u, ry_w, camf, p: MarchParams, alb,
                lightf, lbank=None, plan: MarchPlan | None = None):
    """Kernel C: the unfused march -- kernel A's march, fan and exps,
    the RM -> RP hat upsample and the RGB expansion
    ``img[ch] = wdt(alb_ch * (lcol_ch * P1 + amb_ch * P2))``,
    ``img[3] = wdt(1 - P2)``.  Inputs as ``warp_march`` (any particle
    order) plus ``alb`` [N, 3] fp32 and ``lightf`` [6] fp32 (light
    colour, ambient).  ``plan``: the launch's arm and sizes (default
    ``images_plan`` of these shapes; a plan the kernel cannot take
    raises).  Returns (images [N, 4, RP, RP] in the bank's type, clamp
    count [1] int32)."""
    dev = _check_march(bank, vidx, pgeom, rx_u, ry_w, camf, p, lbank)
    _check(alb, "alb", (torch.float32,), (p.N, 3), dev)
    _check(lightf, "lightf", (torch.float32,), (6,), dev)
    if dev.type != "cuda":
        return warp_images_plain(bank, vidx, pgeom, rx_u, ry_w, camf, p,
                                 alb, lightf, lbank)
    fn = _kernel_fn("warp_images", "warp_images_launch", _IMAGES_ARGS)
    if plan is None:
        aligned = all(t.data_ptr() % 16 == 0 for t in (bank, lbank)
                      if t is not None)
        plan = images_plan(p, bank.element_size(), aligned)
    images = torch.empty((p.N, 4, p.RP, p.RP), dtype=bank.dtype, device=dev)
    clamp = torch.zeros((1,), dtype=torch.int32, device=dev)
    err = fn(_ptr(bank), _ptr(lbank), int(bank.dtype == torch.bfloat16),
             _ptr(vidx), _ptr(pgeom), _ptr(rx_u), _ptr(ry_w), _ptr(camf),
             _ptr(alb), _ptr(lightf), _ptr(images), _ptr(clamp), p, plan,
             _stream(dev))
    if err:
        raise RuntimeError(f"warp_images launch failed: CUDA error {err}")
    warp_images.launches += 1
    return images, clamp


warp_images.launches = 0


# --------------------------------------------------------------------------
# kernel D: composite_chunk

class ChunkParams(ctypes.Structure):
    """Mirrors ``ChunkParams`` in csrc/composite_chunk.cu."""
    _fields_ = [(n, ctypes.c_int) for n in ("n", "RP", "Hc", "Wc")]


@functools.lru_cache(maxsize=64)
def _chunk_plan(key: bytes) -> CompositePlan:
    p = ChunkParams.from_buffer_copy(key)
    return _tile_plan(p.n, p.Hc, p.Wc, p.RP)


def chunk_plan(p: ChunkParams) -> CompositePlan:
    """Kernel D's plan for these shapes (``_tile_plan``, the rects RP x
    RP); where a list does not fit, the tile's warps test every image."""
    # a copy: the cached plan stays as computed whatever a caller does
    return CompositePlan.from_buffer_copy(_chunk_plan(_key(p)))


def _chunk_rects(oy, ox, order, RP: int):
    """The RP x RP rect of the image at each composite position:
    [n, 4] int32 (y0, y1, x0, x1)."""
    k = torch.arange(oy.shape[0], device=oy.device) if order is None \
        else order.long()
    y0, x0 = oy[k], ox[k]
    return torch.stack([y0, y0 + RP, x0, x0 + RP], 1).to(torch.int32)


def chunk_lists_plain(oy, ox, order, p: ChunkParams):
    """Plain PyTorch version of kernel D's per-tile lists: tile t of the
    TILE_H x TILE_W grid lists, ascending (composite order), the
    composite positions q whose image (``order[q]``, or q) has a rect
    that meets it.  Returns (offs [ntiles + 1] int32, lists [offs[-1]]
    int32), as ``tile_lists_plain``.  For tests; the card builds and
    orders the lists inside ``composite_chunk``."""
    rects = _chunk_rects(oy, ox, order, p.RP)
    return tile_lists_plain(rects, torch.ones_like(rects[:, 0]), p.Hc,
                            p.Wc)


_CHUNK_ARGS = {
    "composite_chunk_launch":
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 3 + [ChunkParams, CompositePlan]
        + [ctypes.c_void_p] * 2,
    "composite_chunk_fill":
        [ctypes.c_void_p] * 3 + [ChunkParams, CompositePlan]
        + [ctypes.c_void_p] * 2}


def _check_chunk(oy, ox, order, p: ChunkParams, dev):
    _check(oy, "oy", (torch.int32,), (p.n,), dev)
    _check(ox, "ox", (torch.int32,), (p.n,), dev)
    if order is not None:
        _check(order, "order", (torch.int32,), (p.n,), dev)


def chunk_fill(oy, ox, order, p: ChunkParams,
               plan: CompositePlan | None = None):
    """The first kernel of kernel D's launch alone, for tests and for
    timing that part of D: each composite position appended to the slots
    of every tile its image's rect meets.  Returns (counts [ntiles]
    int32, slots [ntiles, capt] int32) as ``tile_fill`` does; on the CPU
    ``chunk_lists_plain``'s lists in that layout, in order."""
    dev = oy.device
    _check_chunk(oy, ox, order, p, dev)
    plan = chunk_plan(p) if plan is None else plan
    if dev.type != "cuda":
        return _slots_plain(*chunk_lists_plain(oy, ox, order, p), plan)
    scratch = _list_scratch(plan, dev)
    err = _kernel_fn("composite_chunk", "composite_chunk_fill",
                     _CHUNK_ARGS["composite_chunk_fill"])(
        _ptr(oy), _ptr(ox), _ptr(order), p, plan, _ptr(scratch),
        _stream(dev))
    if err:
        raise RuntimeError(f"chunk fill launch failed: CUDA error {err}")
    chunk_fill.launches += 1
    nt = plan.ntx * plan.nty
    return scratch[:nt], scratch[nt:nt * (1 + plan.capt)].view(nt, plan.capt)


chunk_fill.launches = 0


def composite_chunk_plain(canvas, images, oy, ox, order, p: ChunkParams):
    """Plain PyTorch version of kernel D: image by image in composite
    order, the OVER RMW of its canvas rect (canvas updated in place and
    returned)."""
    f32 = torch.float32
    RP = p.RP
    cdt = canvas.dtype
    ks = range(p.n) if order is None else order.tolist()
    y0s, x0s = oy.tolist(), ox.tolist()
    for k in ks:
        ys = slice(y0s[k], y0s[k] + RP)
        xs = slice(x0s[k], x0s[k] + RP)
        img = images[k].to(f32)
        Tw = canvas[3, ys, xs].to(f32)
        canvas[:3, ys, xs] = (canvas[:3, ys, xs].to(f32)
                              + Tw[None] * img[:3]).to(cdt)
        canvas[3, ys, xs] = (Tw * img[3]).to(cdt)
    return canvas


def _check_words(images):
    """Raise unless the aligned 4-byte words that hold bf16 ``images``'
    first and last values lie inside the tensor's storage: kernel D copies
    each bf16 value as the word that holds it, which for an edge value may
    reach 2 bytes outside the tensor (never outside a whole tensor of an
    even number of values that starts on 4 bytes)."""
    if images.dtype != torch.bfloat16 or images.numel() == 0:
        return
    st = images.untyped_storage()
    first = images.data_ptr()
    last = first + 2 * (images.numel() - 1)
    if (first & ~3) < st.data_ptr() or \
            (last & ~3) + 4 > st.data_ptr() + st.nbytes():
        raise ValueError("composite_chunk: the 4-byte words holding the "
                         "bf16 images' first and last values must lie in "
                         "their storage")


def composite_chunk(canvas, images, oy, ox, order, p: ChunkParams,
                    plan: CompositePlan | None = None):
    """Kernel D: OVER of one chunk of per-particle images [n, 4, RP, RP]
    (bf16 or fp32) onto ``canvas`` [4, Hc, Wc] (bf16 or fp32; updated in
    place and returned).  Image k lands with its top-left pixel at
    canvas (``oy[k]``, ``ox[k]``) (int32, inside the canvas); the images
    are composited in the order ``order`` [n] int32 lists them, or as
    stored when it is None.  Per covered pixel:
    ``C_ch = cdt(C_ch + Tw * img_ch)``, ``T = cdt(Tw * img_3)``.
    ``plan``: the launch's tile grid and list slots (default
    ``chunk_plan`` of these shapes; a plan the kernel cannot take
    raises).  On the card, bf16 images must pass ``_check_words``.  One
    counted launch is two kernels: the lists' fill (``chunk_fill``) and
    the walk, which orders each tile's list of composite positions and
    composites it."""
    dev = canvas.device
    n, RP = p.n, p.RP
    dts = (torch.bfloat16, torch.float32)
    _check(canvas, "canvas", dts, (4, p.Hc, p.Wc))
    _check(images, "images", dts, (n, 4, RP, RP), dev)
    _check_chunk(oy, ox, order, p, dev)
    if dev.type != "cuda":
        return composite_chunk_plain(canvas, images, oy, ox, order, p)
    _check_words(images)
    if plan is None:
        plan = chunk_plan(p)
    scratch = _list_scratch(plan, dev)
    err = _kernel_fn("composite_chunk", "composite_chunk_launch",
                     _CHUNK_ARGS["composite_chunk_launch"])(
        _ptr(canvas), int(canvas.dtype == torch.bfloat16), _ptr(images),
        int(images.dtype == torch.bfloat16), _ptr(oy), _ptr(ox),
        _ptr(order), p, plan, _ptr(scratch), _stream(dev))
    if err:
        raise RuntimeError(f"composite_chunk launch failed: CUDA error {err}")
    composite_chunk.launches += 1
    return canvas


composite_chunk.launches = 0
