"""Plain reference of volq's warp renderer: NumPy, scalar and readable.

A frozen copy of the oracle of the JAX package (``volq/oracle/warp_cpu.py``,
its sampling semantics of record) with the static helpers it reads from
``volq/render/warp.py`` and ``volq/render/kernel.py`` copied in, so nothing
here imports the JAX package or the program.  Changes from the original:

* volumes come as each entry's marching slabs (``entry_slabs``), so only
  the entries the rendered particles use are baked;
* ``rows`` renders only the given pixel rows of the full frame: particles
  whose canvas footprint misses every canvas row those pixels read are
  skipped, which leaves those rows exact (each canvas cell composites its
  own particles in depth order);
* ``qname`` names the rounding of every stored tensor (bfloat16 as the
  config states; float8 for the lower-precision control);
* each particle's march runs apart from the composite, so the marches can
  run in worker processes; the composite stays in depth order;
* ``geometry`` is the per-particle geometry the render and the roofline
  counts share.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

f32 = np.float32
_EPS = 1e-6

_MARCH_PERMS = {
    0: (((1, 2, 0), (0, 2, 3, 1)), ((2, 1, 0), (0, 2, 1, 3))),
    1: (((2, 0, 1), (0, 3, 1, 2)), ((0, 2, 1), (0, 3, 2, 1))),
    2: (((0, 1, 2), (0, 1, 2, 3)), ((1, 0, 2), (0, 1, 3, 2))),
}


class Camera(NamedTuple):
    eye: np.ndarray
    right: np.ndarray
    up: np.ndarray
    fwd: np.ndarray
    scale_x: np.float32
    scale_y: np.float32


def make_camera(cc, aspect):
    eye = np.asarray(cc.eye, f32)
    fwd = np.asarray(cc.look_at, f32) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(cc.up, f32))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    if cc.projection == "persp":
        sy = math.tan(math.radians(cc.fov_y_deg) * 0.5)
    else:
        sy = float(cc.ortho_half_h)
    return Camera(eye, right, up, fwd, f32(sy * aspect), f32(sy))


def light_dir(lc):
    d = np.asarray(lc.direction, f32)
    return d / np.linalg.norm(d)


def march_perm(cfg):
    cam = make_camera(cfg.camera, 1.0)
    axis = int(max(range(3), key=lambda i: abs(float(cam.fwd[i]))))
    return max(_MARCH_PERMS[axis],
               key=lambda c: abs(float(cam.right[c[0][0]]))
               + abs(float(cam.up[c[0][1]])))


def needs_row_fan(cfg):
    cam = make_camera(cfg.camera, 1.0)
    vp, _ = march_perm(cfg)
    right = [float(cam.right[i]) for i in vp]
    up = [float(cam.up[i]) for i in vp]
    return bool(abs(right[2]) > 1e-6 or abs(right[1]) > 1e-6
                or abs(up[0]) > 1e-6)


def march_rect(cfg):
    r = cfg.render
    return r.warp_rect if not r.warp_march_rect \
        or r.warp_march_rect >= r.warp_rect else r.warp_march_rect


def slab_vx(cfg, V):
    """x-extent of the marching slabs (the config's warp_slab_vx where
    slab banks are in use and the march telescopes, else V)."""
    r = cfg.render
    item = 4 if r.warp_fp32 else 2
    lit = r.light_steps > 0
    banks = (r.warp_pallas and r.engine == "warp" and r.steps < V
             and (1 + lit) * 2 * r.steps * V * V * item <= 9 * 2 ** 20)
    vx = r.warp_slab_vx
    if vx <= 0 or vx >= V or not banks or (lit and r.light_mode != "center"):
        return V
    return vx


def upsample_weights(RP, RM):
    ratio = f32(RM - 1) / f32(RP - 1)
    p = (np.arange(RP, dtype=f32) * ratio)[:, None]
    Uy = np.maximum(f32(0.0), f32(1.0) - np.abs(p - np.arange(RM, dtype=f32)
                                                [None, :]))
    return Uy, np.ascontiguousarray(Uy.T)


class CanvasGeom(NamedTuple):
    pad: int
    hc_img: int
    wc_img: int
    sup: int
    ratio: float
    coarse: bool


def canvas_geom(cfg, h):
    r = cfg.render
    RP, RM = r.warp_rect, march_rect(cfg)
    if r.warp_coarse:
        ratio = float(f32(RM - 1) / f32(RP - 1))
        return CanvasGeom(RM, int(np.ceil((h - 1) * ratio)) + 1,
                          int(np.ceil((r.width - 1) * ratio)) + 1, RM + 1,
                          ratio, True)
    if r.warp_canvas_scale:
        ratio = float(f32(r.warp_canvas_scale))
        cu = int(np.ceil((RP - 1) * ratio)) + 1
        return CanvasGeom(cu, int(np.ceil((h - 1) * ratio)) + 1,
                          int(np.ceil((r.width - 1) * ratio)) + 1, cu + 1,
                          ratio, True)
    return CanvasGeom(RP, h, r.width, RP, 1.0, False)


def _bf16(x):
    """Round to float32, then to bfloat16 (nearest, ties to even), and
    widen back to float64."""
    u = np.ascontiguousarray(x, np.float64).astype(f32).view(np.uint32)
    u = (u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))) \
        & np.uint32(0xFFFF0000)
    return u.view(f32).astype(np.float64)


def _fp8(x):
    """Round to float32, then to float8 e4m3 (torch's rounding), and widen
    back to float64."""
    import torch
    t = torch.from_numpy(np.ascontiguousarray(x, np.float64))
    return t.to(torch.float32).to(torch.float8_e4m3fn).to(
        torch.float64).numpy()


def quantizer(name):
    """The rounding of stored tensors: "bfloat16" as the configurations
    state, or "float8_e4m3fn" for the lower-precision control."""
    return {"bfloat16": _bf16, "float8_e4m3fn": _fp8}[name]


def _fade(tau, fi, fo):
    return np.clip(np.minimum(tau / max(float(fi), 1e-6),
                              (1.0 - tau) / max(float(fo), 1e-6)), 0.0, 1.0)


def _ray_coords(camera, px, py, W, H, proj):
    px, py = f32(px), f32(py)
    ox = ((px + f32(0.5)) / f32(W) * f32(2.0) - f32(1.0)) * f32(camera.scale_x)
    oy = (f32(1.0) - (py + f32(0.5)) / f32(H) * f32(2.0)) * f32(camera.scale_y)
    right, up, fwd, eye = camera.right, camera.up, camera.fwd, camera.eye
    if proj == "persp":
        dx = fwd[0] + ox * right[0] + oy * up[0]
        dy = fwd[1] + ox * right[1] + oy * up[1]
        dz = fwd[2] + ox * right[2] + oy * up[2]
        dz = np.where(np.abs(dz) < _EPS, np.where(dz >= 0, _EPS, -_EPS),
                      dz).astype(f32)
        return (dx / dz).astype(f32), (dy / dz).astype(f32)
    o_x = eye[0] + ox * right[0] + oy * up[0]
    o_y = eye[1] + ox * right[1] + oy * up[1]
    o_z = eye[2] + ox * right[2] + oy * up[2]
    fz = fwd[2] if abs(float(fwd[2])) >= _EPS else \
        f32(_EPS if fwd[2] >= 0 else -_EPS)
    return ((o_x - o_z * f32(fwd[0] / fz)).astype(f32),
            (o_y - o_z * f32(fwd[1] / fz)).astype(f32))


def engine_coords(pos, camera, cfg):
    """Particle positions and camera in engine coordinates."""
    vp, _ = march_perm(cfg)
    if vp == (0, 1, 2):
        return pos, camera
    vp = list(vp)
    return pos[:, vp], camera._replace(eye=camera.eye[vp],
                                       right=camera.right[vp],
                                       up=camera.up[vp], fwd=camera.fwd[vp])


def geometry(particles, camera, cfg):
    """Per-particle fp32 geometry of the full frame (engine coordinates):
    dict of [N] arrays -- valid, order (composite order), sx0, sy0, px_c,
    py_c, vz, szn, and the canvas rows / columns [cy0, cy1) x [cx0, cx1)
    each particle's placement covers, clipped to the image's canvas."""
    r = cfg.render
    W, H, RP = r.width, r.height, r.warp_rect
    proj = cfg.camera.projection
    pos, camera = engine_coords(np.asarray(particles.pos, f32), camera, cfg)
    size = np.asarray(particles.size, f32)
    eye, right, up, fwd = camera.eye, camera.right, camera.up, camera.fwd
    sx, sy = f32(camera.scale_x), f32(camera.scale_y)
    N = pos.shape[0]
    rel = pos - eye
    vx, vy, vz = rel @ right, rel @ up, rel @ fwd
    if proj == "persp":
        vzs = np.maximum(vz, f32(1e-3))
        px_c = (vx / (vzs * sx) + f32(1.0)) * f32(0.5 * W)
        py_c = (f32(1.0) - vy / (vzs * sy)) * f32(0.5 * H)
        in_front = vz > 1e-3
        szn = np.where(pos[:, 2] - eye[2] >= 0, 1.0, -1.0)
    else:
        px_c = (vx / sx + f32(1.0)) * f32(0.5 * W)
        py_c = (f32(1.0) - vy / sy) * f32(0.5 * H)
        in_front = np.ones_like(vz, bool)
        szn = np.full(N, 1.0 if fwd[2] >= 0 else -1.0)
    alive = np.asarray(particles.age) < np.asarray(particles.lifetime)
    sx0 = (np.round(px_c) - RP // 2).astype(np.int64)
    sy0 = (np.round(py_c) - RP // 2).astype(np.int64)
    valid = alive & in_front & (sx0 > -RP) & (sx0 < W) & (sy0 > -RP) \
        & (sy0 < H)
    if r.near_fade_start > 0.0:
        valid = valid & (vz > r.near_fade_end)
    order = np.argsort(np.where(valid, vz, np.inf), kind="stable")
    g = canvas_geom(cfg, H)
    if g.coarse:
        rc = f32(g.ratio)
        cy0 = np.floor(f32(g.pad) + sy0.astype(f32) * rc).astype(np.int64)
        cx0 = np.floor(f32(g.pad) + sx0.astype(f32) * rc).astype(np.int64)
        lo_y, lo_x = g.pad, g.pad
    else:
        cy0, cx0, lo_y, lo_x = sy0, sx0, 0, 0
    cy1 = np.minimum(cy0 + g.sup, lo_y + g.hc_img)
    cx1 = np.minimum(cx0 + g.sup, lo_x + g.wc_img)
    cy0, cx0 = np.maximum(cy0, lo_y), np.maximum(cx0, lo_x)
    return dict(valid=valid, order=order, sx0=sx0, sy0=sy0, px_c=px_c,
                vol_idx=np.asarray(particles.vol_idx, np.int64),
                py_c=py_c, vz=vz, szn=szn, pos=pos, size=size, camera=camera,
                cy0=cy0, cy1=cy1, cx0=cx0, cx1=cx1, geom=g)


def canvas_rows(cfg, rows):
    """Canvas rows the pixel rows ``rows`` read (a boolean mask over the
    canvas's row index space, padding included)."""
    g = canvas_geom(cfg, cfg.render.height)
    need = np.zeros(g.pad + g.hc_img + g.sup + 2, bool)
    for y0, y1 in rows:
        if g.coarse:
            c0 = int(np.floor(f32(y0) * f32(g.ratio)))
            c1 = int(np.floor(f32(y1 - 1) * f32(g.ratio))) + 2
            need[g.pad + c0:g.pad + min(c1, g.hc_img)] = True
        else:
            need[y0:y1] = True
    return need


def march_z_consts(S, V):
    """(z0, fz) of each march step's z-lerp, in fp32 arithmetic."""
    gsc = np.float32(V - 1)
    out = []
    for s in range(S):
        gz = (np.float32(s) + np.float32(0.5)) / np.float32(S) * gsc
        z0 = np.clip(np.float32(np.floor(gz)), np.float32(0),
                     np.float32(V - 2))
        out.append((int(z0), float(np.clip(gz - z0, np.float32(0),
                                           np.float32(1)))))
    return out


def slab_x_consts(VX, V):
    """(k0, fx) of the align-corners x-resample from V to VX points."""
    out = []
    for i in range(VX):
        p = np.float32(i) * np.float32(V - 1) / np.float32(VX - 1)
        k0 = np.clip(np.float32(np.floor(p)), np.float32(0),
                     np.float32(V - 2))
        out.append((int(k0), float(np.clip(p - k0, np.float32(0),
                                           np.float32(1)))))
    return out


def entry_slabs(vol, cfg):
    """The marching slabs of one engine-coordinate entry [V, V, V] fp32:
    [S, VXe, V], each step's z-lerp then the x-resample, in fp32."""
    V = vol.shape[-1]
    VXe = slab_vx(cfg, V)
    if VXe != V:
        xc = np.asarray(slab_x_consts(VXe, V))
        kx = xc[:, 0].astype(np.int64)
        fx = xc[:, 1].astype(f32)[:, None]
    out = []
    for z0, fz in march_z_consts(cfg.render.steps, V):
        sl = vol[z0] + (vol[z0 + 1] - vol[z0]) * f32(fz)
        if VXe != V:
            a = sl[kx]
            sl = a + (sl[kx + 1] - a) * fx
        out.append(sl)
    return np.stack(out)


def _march_group(job):
    """March the particles of one entry: [(pi, placement or image)]."""
    common, slabs, lslabs, parts = job
    return [(pi, _march(common, slabs, lslabs, q)) for pi, q in parts]


def _march(common, slabs, lslabs, q):
    """One particle's march, fan and exps, up to the composite: on a cell
    canvas its placement (cy0, cx0, placed planes, colour factors), on a
    pixel canvas its rect image [4, RP, RP]."""
    cfg, camera, l_col, l_amb, qname, V = common
    quant = quantizer(qname)
    r = cfg.render
    W, H = r.width, r.height
    RP, K, S = r.warp_rect, r.warp_shift_max, r.steps
    proj = cfg.camera.projection
    qmode = not r.warp_fp32
    row_fan = needs_row_fan(cfg)
    RM = march_rect(cfg)
    lit = lslabs is not None
    centr = lit and r.light_mode == "center"
    coarse = bool(r.warp_coarse or r.warp_canvas_scale)
    MID = S // 2
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    eye, fwd = camera.eye, camera.fwd
    gsc = f32(V - 1)
    gscx = f32(slabs.shape[1] - 1)
    age, lifetime, vz, s3 = q["age"], q["lifetime"], q["vz"], q["szn"]
    sx0, sy0, px_c, py_c = q["sx0"], q["sy0"], q["px_c"], q["py_c"]
    pos, size, albedo = q["pos"], q["size"], q["albedo"]
    uu = np.arange(RM, dtype=f32) * f32((RP - 1) / max(RM - 1, 1))
    half = f32(size)
    ext = f32(2.0) * half
    lo = pos - half
    fade = _fade(age / max(lifetime, 1e-6), r.fade_in,
                 r.fade_out)
    if r.near_fade_start > 0.0:
        span = max(r.near_fade_start - r.near_fade_end, 1e-6)
        fade = fade * np.clip((float(vz) - r.near_fade_end) / span,
                              0.0, 1.0)
    scale = r.density_scale * fade
    rx_u, _ = _ray_coords(camera, f32(sx0) + uu,
                          np.full(RM, py_c, f32) - f32(0.5), W, H,
                          proj)
    _, ry_w = _ray_coords(camera, np.full(RM, px_c, f32) - f32(0.5),
                          f32(sy0) + uu, W, H, proj)
    rx2 = np.float64(1.0) * rx_u[None, :]
    ry2 = np.float64(1.0) * ry_w[:, None]
    if proj == "persp":
        rnorm = np.sqrt(rx2 * rx2 + ry2 * ry2 + 1.0)
        d = np.stack([rx2 / rnorm * s3,
                      np.broadcast_to(ry2 / rnorm, rnorm.shape) * s3,
                      np.broadcast_to(1.0 / rnorm, rnorm.shape) * s3], -1)
        o = np.broadcast_to(eye.astype(np.float64), d.shape)
        dt_raw = float(ext) / S * rnorm
    else:
        fz = float(fwd[2])
        fzs = fz if abs(fz) >= _EPS else (_EPS if fz >= 0 else -_EPS)
        kx, ky = float(fwd[0]) / fzs, float(fwd[1]) / fzs
        ez = float(eye[2])
        o = np.stack([np.broadcast_to(rx2 + ez * kx, (RM, RM)),
                      np.broadcast_to(ry2 + ez * ky, (RM, RM)),
                      np.full((RM, RM), ez)], -1)
        d = np.broadcast_to(fwd.astype(np.float64), (RM, RM, 3))
        dt_raw = np.full((RM, RM), float(ext) / S / abs(fzs))
    sign = np.where(d >= 0, 1.0, -1.0)
    inv = 1.0 / np.where(np.abs(d) < 1e-12, sign * 1e-12, d)
    ta = (f64(lo) - o) * inv
    tb = (f64(pos + half) - o) * inv
    t0 = np.maximum(np.minimum(ta, tb).max(-1), 0.0)
    seg = np.maximum(np.maximum(ta, tb).min(-1) - t0, 0.0)
    dt = np.minimum(dt_raw, seg)
    o_z = o[..., 2]

    Cf = np.zeros((3, RM, RM))
    Cb = np.zeros((3, RM, RM))
    Tp = np.ones((RM, RM))
    od = np.zeros((RM, RM))
    tau_mid = np.zeros((RM, RM))
    p1f = np.zeros((RM, RM))
    p1b = np.zeros((RM, RM))
    for s in range(S):
        zeta = f32((s + 0.5) / S)
        gz = zeta * gsc
        z0 = int(np.clip(np.floor(gz), 0, V - 2))
        fz_ = float(np.clip(gz - z0, 0.0, 1.0))
        zw = f32(lo[2]) + zeta * ext
        kx2o, ky2o = gscx / ext, gsc / ext
        if proj == "persp":
            c1 = f32(zw) - eye[2]
            gx_u = (eye[0] - lo[0]) * kx2o + (c1 * kx2o) * rx_u
            gy_w = (eye[1] - lo[1]) * ky2o + (c1 * ky2o) * ry_w
        else:
            fzp = fwd[2] if abs(float(fwd[2])) >= _EPS else \
                f32(_EPS if fwd[2] >= 0 else -_EPS)
            kxp, kyp = f32(fwd[0] / fzp), f32(fwd[1] / fzp)
            gx_u = (f32(zw) * kxp - lo[0]) * kx2o + kx2o * rx_u
            gy_w = (f32(zw) * kyp - lo[1]) * ky2o + ky2o * ry_w
        inb = ((gy_w >= 0) & (gy_w <= gsc))[:, None] \
            & ((gx_u >= 0) & (gx_u <= gscx))[None, :] \
            & ((float(zw) - o_z) * s3 > 0)
        slab = f64(slabs[s])
        gxc, gyc = np.clip(gx_u, 0, gscx), np.clip(gy_w, 0, gsc)
        sig = _bilin_grid(slab, gxc, gyc, quant if qmode else None)
        alpha = np.where(inb, 1.0 - np.exp(-sig * scale * dt), 0.0)
        if lit:
            lslab = f64(lslabs[s])
            tau = _bilin_grid(lslab, gxc, gyc, quant if qmode else None)
            atten = np.exp(-scale * float(ext) * np.maximum(tau, 0.0))[None]
        else:
            atten = 1.0
        col = albedo[:, None, None] * (l_col[:, None, None] * atten
                                           + l_amb[:, None, None])
        a3 = alpha[None]
        Cf = Cf + (Tp * alpha)[None] * col
        Cb = a3 * col + (1.0 - a3) * Cb
        if coarse and lit and not centr:
            att = atten[0] if isinstance(atten, np.ndarray) else atten
            p1f = p1f + (Tp * alpha) * att
            p1b = alpha * att + (1.0 - alpha) * p1b
        Tp = Tp * (1.0 - alpha)
        if not lit or centr:
            od = od + np.where(inb, sig, 0.0)
        if centr and s == MID:
            tau_mid = np.where(inb, tau, 0.0)

    unlit = not lit
    if unlit:
        planes = (od * scale * dt)[None]
    elif centr:
        planes = np.stack([od * scale * dt,
                           (scale * float(ext)) * np.maximum(tau_mid, 0)])
    elif coarse:
        planes = np.stack([p1f if s3 >= 0 else p1b, 1.0 - Tp])
    else:
        planes = np.concatenate([Cf if s3 >= 0 else Cb, Tp[None]])
    if qmode:
        planes = quant(planes)

    ratio = f32((RP - 1) / max(RM - 1, 1))
    Kc = float(K) / float(ratio)
    du, dw = _fan_shifts(camera, cfg, sx0, sy0, px_c,
                         py_c, RP, row_fan, RM)
    ii = np.arange(RM, dtype=f32)
    nf = 1 if centr else planes.shape[0]
    du = _edge_clamped_shift(du, Kc, RM, ii[None, :])
    planes = np.concatenate([_interp_cols(planes[:nf], ii[None, :] + du),
                             planes[nf:]])
    if row_fan:
        dw = _edge_clamped_shift(dw, Kc, RM, ii[:, None])
        planes = np.concatenate(
            [_interp_rows(planes[:nf], ii[:, None] + dw), planes[nf:]])
    if unlit:
        planes = (1.0 - np.exp(-planes[0]))[None]
    elif centr:
        P2m = 1.0 - np.exp(-planes[0])
        planes = np.stack([np.exp(-planes[1]) * P2m, P2m])

    if coarse:
        g = canvas_geom(cfg, H)
        ratio_c = f32(g.ratio)
        c2m = f32(np.float32((RM - 1) / max(RP - 1, 1)) / np.float32(g.ratio))
        pl_ = quant(planes) if qmode else planes
        ay = f32(g.pad) + f32(sy0) * ratio_c
        ax = f32(g.pad) + f32(sx0) * ratio_c
        cy0, cx0 = int(np.floor(ay)), int(np.floor(ax))
        jv = np.arange(g.sup, dtype=f32)
        mv = np.arange(RM, dtype=f32)
        Uy = np.maximum(0.0, 1.0 - np.abs((jv[:, None] - f32(ay - cy0))
                                          * c2m - mv[None, :]))
        Ux = np.maximum(0.0, 1.0 - np.abs((jv[:, None] - f32(ax - cx0))
                                          * c2m - mv[None, :]))
        if qmode:
            Uy, Ux = quant(Uy), quant(Ux)
        t_ = np.einsum("jm,pmk->pjk", f64(Uy), f64(pl_))
        if qmode:
            t_ = quant(t_)
        placed = np.einsum("pjk,ik->pji", t_, f64(Ux))
        if unlit:
            c1v, c2v = albedo * (l_col + l_amb), np.zeros(3)
        else:
            c1v, c2v = albedo * l_col, albedo * l_amb
        return cy0, cx0, placed, c1v, c2v

    if RM != RP:
        Uy, Ux = upsample_weights(RP, RM)
        if qmode:
            Uy, Ux = quant(Uy), quant(Ux)
        p_ = quant(planes) if qmode else planes
        t_ = np.einsum("im,pmk->pik", f64(Uy), f64(p_))
        if qmode:
            t_ = quant(t_)
        planes = np.einsum("pik,kj->pij", t_, f64(Ux))
    if unlit:
        colc = albedo[:, None, None] * (l_col + l_amb)[:, None, None]
        img = np.concatenate([colc * planes[0][None],
                              (1.0 - planes[0])[None]])
    elif centr:
        P1, P2 = planes
        img = np.concatenate([albedo[:, None, None]
                              * (l_col[:, None, None] * P1[None]
                                 + l_amb[:, None, None] * P2[None]),
                              (1.0 - P2)[None]])
    else:
        img = planes
    if qmode:
        img = quant(img)
    return img


_JOB = 16      # particles a worker marches per task


def render_rows(particles, slabs_of, lslabs_of, camera, light, cfg, rows,
                qname, workers=1):
    """The pixel rows ``rows`` ([(y0, y1), ...]) of the full frame, by warp
    semantics: {(y0, y1): [y1 - y0, W, 4] float64}.  ``slabs_of(e)`` /
    ``lslabs_of(e)`` give bank entry e's marching slabs (``entry_slabs``);
    ``lslabs_of`` None renders unlit.  ``qname``: the dtype stored
    tensors round to.  The particles' marches (independent of each other)
    run in ``workers`` spawned processes; the composite runs here, in
    depth order."""
    r = cfg.render
    W, H = r.width, r.height
    lit = lslabs_of is not None and r.light_steps > 0
    RP = r.warp_rect
    quant = quantizer(qname)
    geo = geometry(particles, camera, cfg)
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    need = canvas_rows(cfg, rows)
    touch = np.array([need[max(a, 0):max(b, 0)].any()
                      for a, b in zip(geo["cy0"], geo["cy1"])], bool)
    todo = [int(pi) for pi in geo["order"]
            if geo["valid"][pi] and touch[pi]]
    vol_idx = np.asarray(particles.vol_idx, np.int64)
    groups = {}
    for pi in todo:
        groups.setdefault(int(vol_idx[pi]), []).append(pi)
    V = cfg.volume.size
    common = (cfg, geo["camera"], f64(light.color), f64(light.ambient), qname,
              V)
    jobs = []
    for e, pis in groups.items():
        sl = slabs_of(e)
        lsl = lslabs_of(e) if lit else None
        parts = [(pi, dict(
            age=float(particles.age[pi]),
            lifetime=float(particles.lifetime[pi]),
            albedo=f64(particles.albedo[pi]), vz=geo["vz"][pi],
            szn=float(geo["szn"][pi]), sx0=int(geo["sx0"][pi]),
            sy0=int(geo["sy0"][pi]), px_c=geo["px_c"][pi],
            py_c=geo["py_c"][pi], pos=geo["pos"][pi],
            size=geo["size"][pi])) for pi in pis]
        for c in range(0, len(parts), _JOB):
            jobs.append((common, sl, lsl, parts[c:c + _JOB]))
    done = {}
    if workers > 1 and len(jobs) > 1:
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, len(jobs))) as pool:
            for res in pool.imap_unordered(_march_group, jobs):
                done.update(res)
    else:
        for job in jobs:
            done.update(_march_group(job))

    g = geo["geom"]
    if g.coarse:
        ratio_c = f32(g.ratio)
        C = np.zeros((3, g.pad + g.hc_img + g.pad + 2,
                      g.pad + g.wc_img + g.pad + 2))
        T = np.ones(C.shape[1:])
    else:
        C = np.zeros((H, W, 3))
        T = np.ones((H, W))
    for pi in todo:
        if g.coarse:
            cy0, cx0, placed, c1v, c2v = done[pi]
            sup = g.sup
            Tw = T[cy0:cy0 + sup, cx0:cx0 + sup]
            T2 = Tw * placed[-1]
            Cn = C[:, cy0:cy0 + sup, cx0:cx0 + sup] \
                + (c1v[:, None, None] * (Tw * placed[0])
                   + c2v[:, None, None] * T2)
            Tn = Tw - T2
            if not r.warp_canvas_fp32:
                Cn, Tn = quant(Cn), quant(Tn)
            C[:, cy0:cy0 + sup, cx0:cx0 + sup] = Cn
            T[cy0:cy0 + sup, cx0:cx0 + sup] = Tn
            continue
        img = done[pi]
        x0, y0 = int(geo["sx0"][pi]), int(geo["sy0"][pi])
        fx0, fy0 = max(x0, 0), max(y0, 0)
        fx1, fy1 = min(x0 + RP, W), min(y0 + RP, H)
        if fx1 <= fx0 or fy1 <= fy0:
            continue
        wi = img[:, fy0 - y0:fy1 - y0, fx0 - x0:fx1 - x0]
        Tw = T[fy0:fy1, fx0:fx1]
        Cn = C[fy0:fy1, fx0:fx1] + (Tw[None] * wi[:3]).transpose(1, 2, 0)
        Tn = Tw * wi[3]
        if not r.warp_canvas_fp32:
            Cn, Tn = quant(Cn), quant(Tn)
        C[fy0:fy1, fx0:fx1] = Cn
        T[fy0:fy1, fx0:fx1] = Tn

    bg = np.asarray(r.background, np.float64)
    out = {}
    if g.coarse:
        Cc = C[:, g.pad:g.pad + g.hc_img, g.pad:g.pad + g.wc_img]
        Tc = T[g.pad:g.pad + g.hc_img, g.pad:g.pad + g.wc_img]

        def up_w(p, n):
            return np.maximum(0.0, 1.0 - np.abs(
                (np.asarray(p, f32)[:, None] * ratio_c)
                - np.arange(n, dtype=f32)[None, :]))

        Fx = f64(up_w(np.arange(W), g.wc_img))
        for y0, y1 in rows:
            # rows, then columns (a 3-operand einsum would not factor)
            Fy = f64(up_w(np.arange(y0, y1), g.hc_img))
            Ci = np.einsum("pkw,qw->pqk", np.einsum("ph,khw->pkw", Fy, Cc),
                           Fx)
            Ti = (Fy @ Tc) @ Fx.T
            out[y0, y1] = np.concatenate([Ci + Ti[..., None] * bg,
                                          (1.0 - Ti)[..., None]], -1)
        return out
    for y0, y1 in rows:
        out[y0, y1] = np.concatenate([C[y0:y1] + T[y0:y1, :, None] * bg,
                                      (1.0 - T[y0:y1])[..., None]], -1)
    return out


def _bilin_grid(slab, gx_u, gy_w, quant):
    """Separable bilinear with the device's intermediate rounding: y pass
    first (rounded), then x.  out[w, u]."""
    Vx, Vy = slab.shape
    x0 = np.clip(np.floor(gx_u), 0, Vx - 2).astype(np.int64)
    y0 = np.clip(np.floor(gy_w), 0, Vy - 2).astype(np.int64)
    fx = np.clip(gx_u - x0, 0.0, 1.0)
    fy = np.clip(gy_w - y0, 0.0, 1.0)
    if quant is not None:
        slab = quant(slab)
        w0x, w1x, w0y, w1y = (quant(w) for w in (1.0 - fx, fx, 1.0 - fy, fy))
    else:
        w0x, w1x, w0y, w1y = 1.0 - fx, fx, 1.0 - fy, fy
    t1 = (slab[:, y0] * w0y + slab[:, y0 + 1] * w1y).T
    if quant is not None:
        t1 = quant(t1)
    return t1[:, x0] * w0x + t1[:, x0 + 1] * w1x


def _safe_div(num, den):
    sgn = np.where(den >= 0, f32(1.0), f32(-1.0))
    return (num / (sgn * np.maximum(np.abs(den), f32(1e-12)))).astype(f32)


def _fan_shifts(camera, cfg, sx0, sy0, px_c, py_c, RP, row_fan, RM):
    """fp32 fan-correction shifts of one particle at the RM march positions,
    in march cells: (du [RM, RM], dw [RM, RM] or None)."""
    ratio = f32((RP - 1) / max(RM - 1, 1))
    r = cfg.render
    W, H = f32(r.width), f32(r.height)
    right, up, fwd = camera.right, camera.up, camera.fwd
    sx, sy = f32(camera.scale_x), f32(camera.scale_y)
    dox_step = f32(2.0) * sx / W * ratio
    doy_step = f32(-2.0) * sy / H * ratio
    iv = (np.arange(RM, dtype=f32) * ratio)[None, :]
    jv = (np.arange(RM, dtype=f32) * ratio)[:, None]
    sx0f, sy0f = f32(sx0), f32(sy0)
    doy_j = (f32(py_c) - (sy0f + jv + f32(0.5))) * (f32(2.0) * sy / H)
    dox_i = ((sx0f + iv + f32(0.5)) - f32(px_c)) * (f32(2.0) * sx / W)
    if cfg.camera.projection == "ortho":
        fz = fwd[2] if abs(float(fwd[2])) >= _EPS else \
            f32(_EPS if fwd[2] >= 0 else -_EPS)
        kx, ky = f32(fwd[0] / fz), f32(fwd[1] / fz)
        du = np.broadcast_to(_safe_div(doy_j * (up[0] - up[2] * kx),
                                       dox_step * (right[0] - right[2] * kx)),
                             (RM, RM)).astype(f32)
        if not row_fan:
            return du, None
        dw = np.broadcast_to(_safe_div(dox_i * (right[1] - right[2] * ky),
                                       doy_step * (up[1] - up[2] * ky)),
                             (RM, RM)).astype(f32)
        return du, dw
    ox_i = ((sx0f + iv + f32(0.5)) * (f32(2.0) / W) - f32(1.0)) * sx
    oy_c = (f32(1.0) - f32(py_c) * (f32(2.0) / H)) * sy
    D_ic = fwd[2] + ox_i * right[2] + oy_c * up[2]
    Nx_ic = fwd[0] + ox_i * right[0] + oy_c * up[0]
    Fy_i = up[0] * D_ic - Nx_ic * up[2]
    Gx_i = right[0] * D_ic - Nx_ic * right[2]
    D_ip1 = D_ic + dox_step * right[2]
    D_ij = (D_ic + doy_j * up[2]).astype(f32)
    du = _safe_div(doy_j * _safe_div(Fy_i * D_ip1, dox_step * Gx_i), D_ij)
    if not row_fan:
        return du, None
    oy_j = (f32(1.0) - (sy0f + jv + f32(0.5)) * (f32(2.0) / H)) * sy
    ox_c = (f32(px_c) * (f32(2.0) / W) - f32(1.0)) * sx
    D_cj = fwd[2] + oy_j * up[2] + ox_c * right[2]
    Ny_cj = fwd[1] + oy_j * up[1] + ox_c * right[1]
    Fx_j = right[1] * D_cj - Ny_cj * right[2]
    Gy_j = up[1] * D_cj - Ny_cj * up[2]
    D_jp1 = D_cj + doy_step * up[2]
    D_ij2 = (D_cj + dox_i * right[2]).astype(f32)
    dw = _safe_div(dox_i * _safe_div(Fx_j * D_jp1, doy_step * Gy_j), D_ij2)
    return du, dw


def _edge_clamped_shift(raw, K, RP, axis_idx):
    du = np.clip(raw.astype(f32), f32(-K), f32(K - 1e-3))
    du = np.maximum(du, -axis_idx)
    return np.minimum(du, f32(RP - 1.0 - 1e-3) - axis_idx)


def _interp_cols(img, u_star):
    RP = img.shape[-1]
    u0 = np.clip(np.floor(u_star), 0, RP - 2).astype(np.int64)
    fr = np.clip(u_star - u0, 0.0, 1.0)
    jj = np.arange(RP)[:, None]
    return img[:, jj, u0] * (1.0 - fr) + img[:, jj, u0 + 1] * fr


def _interp_rows(img, w_star):
    RP = img.shape[1]
    w0 = np.clip(np.floor(w_star), 0, RP - 2).astype(np.int64)
    fr = np.clip(w_star - w0, 0.0, 1.0)
    ii = np.arange(RP)[None, :]
    return img[:, w0, ii] * (1.0 - fr) + img[:, w0 + 1, ii] * fr
