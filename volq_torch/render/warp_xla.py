"""The warp engine's XLA path (``warp_pallas=False``, the engine's
default): the non-Pallas functions of ``volq/render/warp.py`` in plain
torch.  The reference runs them as XLA ops; there is no kernel here.

Per frame: rotate the scene into engine coordinates (particles, camera
and the volume banks), compute the grid geometry, order the particles by
view depth, then per depth-ordered megachunk of at most ``warp_mega``
particles (``warp.mega_chunk``) and per chunk of ``warp_chunk`` of them:

* ``_march_images``: the slope-grid march straight from the volumes (no
  slab banks: each step lerps its two z-slices, ``_fetch_slabs``), the
  trilinear sample as two hat-matrix products per step, telescoped when
  unlit or center-lit, the OVER recurrence (front and back accumulators)
  when per-step lit, both projections;
* ``_warp_images``: the closed-form fan shift (``fan_shifts``) at march
  resolution, the exps, the RM -> RP hat upsample and the RGB expansion;
* ``_composite_chunk``: OVER of the chunk's images onto the carried
  canvas, particle by particle.

The hat matrices have two non-zeros a row, so the products are exact
sums of two terms; they run as fp32 matmuls of working-type operands (a
bf16 product is exact in fp32), which is the reference's
``preferred_element_type=float32``.  On the card this relies on
PyTorch's default fp32 matmul precision (no TF32).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from volq_torch.core.types import Camera, Light, Particles
from volq_torch.render import kernel as K
from volq_torch.render import warp as W
from volq_torch.scene.config import SceneConfig

ONEHOT_MAX_BANK = 64
f32 = torch.float32


def _wdt(cfg: SceneConfig):
    return f32 if cfg.render.warp_fp32 else torch.bfloat16


def _mm(a, b, dtype=f32):
    """a @ b of working-type operands, summed in fp32, cast to ``dtype``."""
    return torch.matmul(a.to(f32), b.to(f32)).to(dtype)


def _hat(g, size: int, dtype):
    """Dense 1-D hat weights W[..., v] = max(0, 1 - |g - v|)."""
    v = torch.arange(size, dtype=f32, device=g.device)
    return torch.clamp(1.0 - torch.abs(g[..., None] - v), min=0.0).to(dtype)


def _fetch_slabs(volumes, rows2d, vol_rows, z0: int, fz: float, M: int,
                 V: int, dtype):
    """The z-lerped [V, V] slab at (z0, fz) of a shared bank, or the
    [c, V, V] slabs of a chunk's volumes: the one-hot product for banks of
    at most ONEHOT_MAX_BANK entries, a row gather above."""
    if M == 1:
        sl = volumes[0, z0:z0 + 2].to(f32)
        return (sl[0] + (sl[1] - sl[0]) * fz).to(dtype)
    if M <= ONEHOT_MAX_BANK:
        sl = volumes[:, z0:z0 + 2].to(f32)
        lerped = (sl[:, 0] + (sl[:, 1] - sl[:, 0]) * fz).to(dtype)
        onehot = (vol_rows[:, None].long() == torch.arange(
            M, device=vol_rows.device)).to(dtype)
        return _mm(onehot, lerped.reshape(M, V * V), dtype) \
            .reshape(-1, V, V)
    base = vol_rows.long() * V + z0
    sl0 = rows2d[base].to(f32)
    sl1 = rows2d[base + 1].to(f32)
    return (sl0 + (sl1 - sl0) * fz).to(dtype).reshape(-1, V, V)


def _step_consts(S: int, V: int):
    """(zeta, z0, fz) of every marching step, the fp32 arithmetic of the
    reference's ``(s + 0.5) / S`` and z-lerp."""
    zeta = [float((np.float32(s) + np.float32(0.5)) / np.float32(S))
            for s in range(S)]
    return [(zt, z0, fz) for zt, (z0, fz) in zip(zeta,
                                                 W._march_z_consts(S, V))]


def _chunks(cfg: SceneConfig, N: int) -> int:
    """Particles per ``warp_chunk`` chunk: the largest divisor of N not
    above it."""
    chunk = max(min(cfg.render.warp_chunk, N), 1)
    while N % chunk:
        chunk -= 1
    return chunk


def _march_images(particles: Particles, volumes, camera: Camera,
                  cfg: SceneConfig, geom, light_volumes=None):
    """March every particle's slope grid (engine coordinates).  Returns
    the planes at march resolution [N, 1|2, RM, RM] in the working type:
    (q,) the linear optical depth times scale*dt unlit, (q, tau')
    center-lit, (P1, P2) per-step lit."""
    r = cfg.render
    RM = W.march_rect(cfg)
    V, M = volumes.shape[-1], volumes.shape[0]
    S = r.steps
    N = particles.age.shape[0]
    persp = cfg.camera.projection == "persp"
    wdt = _wdt(cfg)
    gsc = float(V - 1)
    coeffs = W._plane_pos_coeffs(camera, cfg.camera.projection)
    lit = light_volumes is not None
    center = lit and r.light_mode == "center"
    MID = S // 2
    rows2d = volumes.reshape(M * V, V * V) if M > ONEHOT_MAX_BANK else None
    lrows2d = (light_volumes.reshape(M * V, V * V)
               if lit and M > ONEHOT_MAX_BANK else None)
    steps = _step_consts(S, V)

    def chunk_fn(pos, half, vol_rows, rx_u, ry_w, szn, scale, valid):
        c = pos.shape[0]
        lo = pos - half[:, None]
        ext = 2.0 * half
        lo_x, lo_y, lo_z = lo[:, 0], lo[:, 1], lo[:, 2]
        rx2, ry2 = rx_u[:, None, :], ry_w[:, :, None]
        szn3 = szn[:, None, None]
        shape = (c, RM, RM)
        if persp:
            rnorm = torch.sqrt(rx2 * rx2 + ry2 * ry2 + 1.0)
            inv_n = torch.ones_like(rnorm) / rnorm
            d_x, d_y, d_z = rx2 * inv_n * szn3, ry2 * inv_n * szn3, \
                inv_n * szn3
            o_x, o_y = camera.eye[0], camera.eye[1]
            o_z = camera.eye[2].expand(shape)
            dt_raw = (ext / S)[:, None, None] * rnorm
        else:
            # rx / ry are z = 0 intercepts; the ray origin sits on the
            # camera plane z = eye_z, so t > 0 means "in front"
            kx, ky = W._fwd_slopes(camera)
            fzs = K._sign_eps(camera.fwd[2])
            ez = camera.eye[2]
            o_x = (rx2 + ez * kx).expand(shape)
            o_y = (ry2 + ez * ky).expand(shape)
            o_z = ez.expand(shape)
            d_x, d_y, d_z = (camera.fwd[i].expand(shape) for i in range(3))
            dt_raw = ((ext / S)[:, None, None] / torch.abs(fzs)) \
                .expand(shape)
        hi = pos + half[:, None]
        l3, h3 = lo[:, None, None, :], hi[:, None, None, :]
        t0x, t1x = K._axis_seg(o_x, d_x, l3[..., 0], h3[..., 0])
        t0y, t1y = K._axis_seg(o_y, d_y, l3[..., 1], h3[..., 1])
        t0z, t1z = K._axis_seg(o_z, d_z, l3[..., 2], h3[..., 2])
        t0 = torch.maximum(torch.maximum(t0x, t0y),
                           torch.clamp(t0z, min=0.0))
        t1 = torch.minimum(torch.minimum(t1x, t1y), t1z)
        dt = torch.minimum(dt_raw, torch.clamp(t1 - t0, min=0.0))
        sc3 = scale[:, None, None]
        pv3 = valid[:, None, None]
        ext3 = ext[:, None, None]

        zero = torch.zeros(shape, dtype=f32, device=pos.device)
        od = tau_c = P1f = P1b = P2b = zero
        T = torch.ones_like(zero)
        for s, (zeta, z0, fz) in enumerate(steps):
            zw = lo_z + zeta * ext                            # [c]
            c0x, c1x, c0y, c1y = coeffs(zw)
            # hoisted association: gx = (c0x - lo_x)*k2 + (c1x*k2)*rx
            k2 = gsc / ext
            gx_u = ((c0x - lo_x) * k2)[:, None] + (c1x * k2)[:, None] * rx_u
            gy_w = ((c0y - lo_y) * k2)[:, None] + (c1y * k2)[:, None] * ry_w
            inx = (gx_u >= 0) & (gx_u <= gsc)
            iny = (gy_w >= 0) & (gy_w <= gsc)
            tpos = (zw[:, None, None] - o_z) * szn3 > 0
            inb = iny[:, :, None] & inx[:, None, :] & tpos & pv3
            Wx = _hat(torch.clamp(gx_u, 0, gsc), V, wdt)      # [c, RM, V(a)]
            Wy = _hat(torch.clamp(gy_w, 0, gsc), V, wdt)      # [c, RM, V(b)]
            WxT = Wx.transpose(1, 2)
            slab = _fetch_slabs(volumes, rows2d, vol_rows, z0, fz, M, V, wdt)
            if lit:
                lslab = _fetch_slabs(light_volumes, lrows2d, vol_rows, z0,
                                     fz, M, V, wdt)
                sl2 = torch.stack([slab, lslab], dim=-3)      # [(c,) 2, V, V]
                t1_ = _mm(Wy[:, None], sl2.transpose(-1, -2), wdt)
                both = _mm(t1_, WxT[:, None])                 # [c, 2, RM, RM]
                sig, tau = both[:, 0], both[:, 1]
            else:
                t1_ = _mm(Wy, slab.transpose(-1, -2), wdt)    # [c, RM, V(a)]
                sig, tau = _mm(t1_, WxT), None
            if center:
                od = od + torch.where(inb, sig, 0.0)
                if s == MID:
                    tau_c = torch.where(inb, tau, 0.0)
            elif lit:
                alpha = torch.where(inb, 1.0 - torch.exp(-sig * sc3 * dt),
                                    0.0)
                fa = T * alpha
                atten = torch.exp(-sc3 * ext3 * torch.clamp(tau, min=0.0))
                P1f = P1f + fa * atten
                P1b = alpha * atten + (1.0 - alpha) * P1b
                P2b = alpha + (1.0 - alpha) * P2b
                T = T - fa
            else:
                # unlit telescopes: one optical-depth plane, one exp later
                od = od + torch.where(inb, sig, 0.0)

        if lit and not center:
            fwd3 = (szn >= 0)[:, None, None]
            planes = torch.stack([torch.where(fwd3, P1f, P1b),
                                  torch.where(fwd3, 1.0 - T, P2b)], dim=1)
        elif center:
            planes = torch.stack([od * sc3 * dt,
                                  (sc3 * ext3) * torch.clamp(tau_c, min=0.0)],
                                 dim=1)
        else:
            planes = (od * sc3 * dt)[:, None]
        # invalid particles contribute the OVER identity (P = 0 -> T = 1)
        planes = torch.where(valid[:, None, None, None], planes, 0.0)
        return planes.to(wdt)

    chunk = _chunks(cfg, N)
    args = (particles.pos.to(f32), particles.size.to(f32), particles.vol_idx,
            geom["rx_u"], geom["ry_w"], geom["szn"], geom["scale"],
            geom["valid"])
    return torch.cat([chunk_fn(*(a[i:i + chunk] for a in args))
                      for i in range(0, N, chunk)])


def _shift_interp(img, delta, K: int, axis: int):
    """out = sum over the static shifts d in [-K, K] of w_d * img shifted
    by d, with the combined weight w_d = (d0 == d)(1 - f) + (d0 == d-1) f
    (d0 = floor(delta)): the reference's fan resampling.  ``axis`` is the
    shifted axis of img [c, P, R, R] (2 rows, 3 columns); delta [c, R, R]
    is edge-clamped, so the zero padding is never sampled.  fp32."""
    d0 = torch.floor(delta)
    fr = delta - d0
    pads = (K, K) if axis == 3 else (0, 0, K, K)
    pad = F.pad(img.to(f32), pads)
    R = img.shape[axis]
    out = torch.zeros(img.shape, dtype=f32, device=img.device)
    m_prev = torch.zeros_like(d0)
    for d in range(-K, K + 1):
        m = (d0 == d).to(f32) if d <= K - 1 else torch.zeros_like(d0)
        w = (m + fr * (m_prev - m))[:, None]
        out = out + w * pad.narrow(axis, K + d, R)
        m_prev = m
    return out


def fan_shifts(camera: Camera, cfg: SceneConfig, sx0, sy0, px_c, py_c):
    """The fan shifts du (and dw for yawed or rolled cameras) at the RM
    march-grid positions in march cells, in the reference's closed,
    cancellation-free form; orthographic rx is affine in the pixel, so du
    and dw are constant ratios.  Inputs [c]; returns (du [c, RM, RM], dw
    [c, RM, RM] or None)."""
    r = cfg.render
    RP, RM = r.warp_rect, W.march_rect(cfg)
    c = sx0.shape[0]
    dev = sx0.device
    ratio = float(np.float32((RP - 1) / max(RM - 1, 1)))
    Wf, Hf = float(r.width), float(r.height)
    row_fan = W.needs_row_fan(cfg)
    rx_, ry_, rz_ = camera.right[0], camera.right[1], camera.right[2]
    ux, uy, uz = camera.up[0], camera.up[1], camera.up[2]
    fx, fy, fz = camera.fwd[0], camera.fwd[1], camera.fwd[2]
    sx, sy = camera.scale_x, camera.scale_y
    dox = 2.0 * sx / Wf * ratio              # ox step per march column
    doy_step = -2.0 * sy / Hf * ratio        # oy step per march row

    iv = torch.arange(RM, dtype=f32, device=dev) * ratio
    sx0f, sy0f = sx0[:, None].to(f32), sy0[:, None].to(f32)
    ox_i = ((sx0f + iv + 0.5) * (2.0 / Wf) - 1.0) * sx      # [c, RM]
    oy_j = (1.0 - (sy0f + iv + 0.5) * (2.0 / Hf)) * sy      # [c, RM]
    doy_j = (py_c[:, None] - (sy0f + iv + 0.5)) * (2.0 * sy / Hf)
    dox_i = ((sx0f + iv + 0.5) - px_c[:, None]) * (2.0 * sx / Wf)

    if cfg.camera.projection == "ortho":
        kx, ky = W._fwd_slopes(camera)
        du = K._safe_div(doy_j * (ux - uz * kx), dox * (rx_ - rz_ * kx))
        du = du[:, :, None].expand(c, RM, RM)
        if not row_fan:
            return du, None
        dw = K._safe_div(dox_i * (ry_ - rz_ * ky), doy_step * (uy - uz * ky))
        return du, dw[:, None, :].expand(c, RM, RM)

    oy_c = ((1.0 - py_c * (2.0 / Hf)) * sy)[:, None]         # [c, 1]
    D_ic = fz + ox_i * rz_ + oy_c * uz                      # [c, RM(i)]
    Nx_ic = fx + ox_i * rx_ + oy_c * ux
    Fy_i = ux * D_ic - Nx_ic * uz
    Gx_i = rx_ * D_ic - Nx_ic * rz_
    D_ip1 = D_ic + dox * rz_
    D_ij = D_ic[:, None, :] + (doy_j * uz)[:, :, None]      # [c, RM(j), RM(i)]
    A_i = K._safe_div(Fy_i * D_ip1, dox * Gx_i)
    du = K._safe_div(doy_j[:, :, None] * A_i[:, None, :], D_ij)
    if not row_fan:
        return du, None
    ox_c = ((px_c * (2.0 / Wf) - 1.0) * sx)[:, None]
    D_cj = fz + oy_j * uz + ox_c * rz_                      # [c, RM(j)]
    Ny_cj = fy + oy_j * uy + ox_c * ry_
    Fx_j = ry_ * D_cj - Ny_cj * rz_
    Gy_j = uy * D_cj - Ny_cj * uz
    D_jp1 = D_cj + doy_step * uz
    B_j = K._safe_div(Fx_j * D_jp1, doy_step * Gy_j)
    dw = K._safe_div(dox_i[:, None, :] * B_j[:, :, None], D_ij)
    return du, dw


def _edge_clamped_shift(raw, Kc: float, R: int, axis_idx):
    """Clamp the fan shift to [-Kc, Kc - 1e-3] and so that index + shift
    stays in [0, R - 1); returns (shift, mask of the shifts the Kc clamp
    cut).  ``axis_idx`` indexes the shifted axis (broadcastable)."""
    lo, hi = K._f32(Kc), K._f32(Kc - 1e-3)
    clamped = (raw < -lo) | (raw > hi)
    d = torch.clamp(raw, -lo, hi)
    d = torch.maximum(d, -axis_idx)
    return torch.minimum(d, K._f32(R - 1.0 - 1e-3) - axis_idx), clamped


def _warp_images(images, particles: Particles, camera: Camera, light: Light,
                 cfg: SceneConfig, geom):
    """Fan shift (columns, then rows for yawed cameras) of the march
    planes at march resolution, the exps, the hat upsample to the rect
    and the RGB expansion.  Returns (images [N, 4, RP, RP] fp32 --
    premultiplied C, T --, shift_clamped count)."""
    r = cfg.render
    RP, RM = r.warp_rect, W.march_rect(cfg)
    ratio = (RP - 1) / max(RM - 1, 1)
    Kc = r.warp_shift_max / ratio
    Km = r.warp_shift_max if RM == RP else -int(-Kc // 1)
    N = images.shape[0]
    center = images.shape[1] == 2 and r.light_mode == "center"
    lit = images.shape[1] == 2 and not center
    wdt = _wdt(cfg)
    dev = images.device
    l_col = light.color.to(f32)[None, :, None, None]
    l_amb = light.ambient.to(f32)[None, :, None, None]
    if RM != RP:
        Uy, Ux = (torch.from_numpy(u).to(dev, wdt)
                  for u in W.upsample_weights(RP, RM))
    iif = torch.arange(RM, dtype=f32, device=dev)

    def chunk_fn(img, albedo, sx0, sy0, px_c, py_c, valid):
        du_raw, dw_raw = fan_shifts(camera, cfg, sx0, sy0, px_c, py_c)
        du, clampx = _edge_clamped_shift(du_raw, Kc, RM, iif[None, None, :])
        clamp_total = (valid[:, None, None] & clampx).sum(dtype=torch.int32)

        def fan(im, delta, axis):
            # center-lit: the smooth attenuation plane skips the fan
            if center:
                return torch.cat([_shift_interp(im[:, :1], delta, Km, axis),
                                  im[:, 1:].to(f32)], dim=1)
            return _shift_interp(im, delta, Km, axis)

        out = fan(img, du, 3)
        if dw_raw is not None:
            dw, clampy = _edge_clamped_shift(dw_raw, Kc, RM,
                                             iif[None, :, None])
            clamp_total = clamp_total + (valid[:, None, None] & clampy) \
                .sum(dtype=torch.int32)
            out = fan(out, dw, 2)
        # the unlit / center exps at march resolution, before the upsample
        if lit:
            pl_m = out
        elif center:
            P2m = 1.0 - torch.exp(-out[:, 0])
            pl_m = torch.stack([torch.exp(-out[:, 1]) * P2m, P2m], dim=1)
        else:
            pl_m = (1.0 - torch.exp(-out[:, 0]))[:, None]
        if RM != RP:
            t_ = _mm(Uy, pl_m.to(wdt), wdt)                   # [c, p, RP, RM]
            pl_m = _mm(t_, Ux)                                # [c, p, RP, RP]
        P2 = pl_m[:, -1]
        P1 = pl_m[:, 0]     # == P2 unlit (atten == 1)
        col = albedo[:, :, None, None] * (l_col * P1[:, None]
                                          + l_amb * P2[:, None])
        return torch.cat([col, (1.0 - P2)[:, None]], dim=1), clamp_total

    chunk = _chunks(cfg, N)
    args = (images, particles.albedo.to(f32), geom["sx0"], geom["sy0"],
            geom["px_c"], geom["py_c"], geom["valid"])
    outs, total = [], torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(0, N, chunk):
        o, cl = chunk_fn(*(a[i:i + chunk] for a in args))
        outs.append(o)
        total = total + cl
    return torch.cat(outs), total


def _canvas_init(cfg: SceneConfig, h_local: int, device):
    """The XLA path's padded canvas: C [3, Hc, Wc] = 0, T [Hc, Wc] = 1,
    bf16 unless warp_canvas_fp32, RP cells of padding on every side."""
    r = cfg.render
    RP = r.warp_rect
    cdt = f32 if r.warp_canvas_fp32 else torch.bfloat16
    Hc, Wc = h_local + 2 * RP, r.width + 2 * RP
    return (torch.zeros((3, Hc, Wc), dtype=cdt, device=device),
            torch.ones((Hc, Wc), dtype=cdt, device=device))


def _composite_chunk(canvas, images, geom, cfg: SceneConfig, y_start: int):
    """OVER a chunk of depth-ordered images onto the carried canvas, in
    place, particle by particle."""
    RP = cfg.render.warp_rect
    C, T = canvas
    cdt = C.dtype
    Hc, Wc = T.shape
    oy = torch.clamp(geom["sy0"] - y_start + RP, 0, Hc - RP).tolist()
    ox = torch.clamp(geom["sx0"] + RP, 0, Wc - RP).tolist()
    for k in range(images.shape[0]):
        img = images[k].to(f32)
        ys, xs = slice(oy[k], oy[k] + RP), slice(ox[k], ox[k] + RP)
        Tw = T[ys, xs].to(f32)
        C[:, ys, xs] = (C[:, ys, xs].to(f32) + Tw[None] * img[:3]).to(cdt)
        T[ys, xs] = (Tw * img[3]).to(cdt)
    return C, T


def render_warp_canvas_xla(particles: Particles, volumes, camera: Camera,
                           light: Light, cfg: SceneConfig, light_volumes,
                           y_start: int, h_local: int):
    """``warp.render_warp_canvas`` on the XLA path: the depth-ordered
    megachunks marched from the volumes (and light volumes when lit) and
    composited in turn.  Returns (canvas [4, Hc, Wc], stats)."""
    N = particles.age.shape[0]
    particles, camera = W.permute_for_march(particles, camera, cfg)
    _, ap = W._march_perm(cfg)
    if ap != (0, 1, 2, 3):
        volumes = volumes.permute(ap)
        if light_volumes is not None:
            light_volumes = light_volumes.permute(ap)
    geom, stats = W._grid_geometry(particles, camera, cfg, y_start, h_local)
    order = W._depth_order(geom)
    C = W.mega_chunk(cfg, N)
    canvas = _canvas_init(cfg, h_local, particles.pos.device)
    shift_clamped = torch.zeros((), dtype=torch.int32,
                                device=particles.pos.device)
    for m in range(N // C):
        pm, gm = W._take(particles, geom, order[m * C:(m + 1) * C])
        images = _march_images(pm, volumes, camera, cfg, gm, light_volumes)
        images, sc = _warp_images(images, pm, camera, light, cfg, gm)
        canvas = _composite_chunk(canvas, images, gm, cfg, y_start)
        shift_clamped = shift_clamped + sc
    return (torch.cat([canvas[0], canvas[1][None]]),
            dict(stats, shift_clamped=shift_clamped))
