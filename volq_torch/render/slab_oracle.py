"""The slab engine's CPU oracle: a copy of the JAX package's
``volq/oracle/slab_cpu.py`` (and of the two helpers it takes from
``raymarch_cpu.py``), so the port can hold its slab engine to the
sampling spec of record on a machine without the JAX package
(``chip_smoke.py``).  float64 numpy; bf16 rounding through torch.
``tests/test_torch_slab.py`` holds the copy equal to the original.

The spec (the original's words):

The CPU oracle for the SLAB renderer (render/slab.py) — its sampling
semantics of record, held to the same 1e-3 per-pixel budget.

Differences from the per-ray oracle (raymarch_cpu.py):

  * Quadrature: ``steps`` planes at fixed LOCAL volume z,
    zeta_s = (s + 0.5) / steps; a ray samples plane s where it crosses it
    (t_s = (z_s - o.z) / d.z, with |d.z| clamped to 1e-6), and the sample
    counts iff t_s > 0 and the in-plane coords lie inside the volume.
  * dt = plane spacing along the ray, min(ext_z / steps / |d.z|, seg)
    where seg is the slab-test segment length (bounds dt for rays nearly
    perpendicular to the marching axis).
  * Planes are composited in the ray's near-to-far order (ascending z for
    d.z >= 0, descending otherwise).
  * Lighting samples a precomputed light-transmittance volume
    (volume/lightbake.py semantics, baked here identically on the CPU)
    instead of marching secondary rays per sample.

Everything else (depth-sorted per-particle compositing, fade envelope,
trilinear/bilinear weight definitions, bf16 grid storage) matches
raymarch_cpu.py; float64 accumulation — the oracle is the math, device
fp32 drift stays within the tolerance.
"""
from __future__ import annotations

import numpy as np
import torch

_DZ_EPS = 1e-6


def _fade(tau, fade_in, fade_out):
    fi = max(float(fade_in), 1e-6)
    fo = max(float(fade_out), 1e-6)
    return np.clip(np.minimum(tau / fi, (1.0 - tau) / fo), 0.0, 1.0)


def _ray_aabb(o, d, lo, hi):
    """Vectorized slab test. o, d: [..., 3]; lo, hi: [3]; |d| clamped to
    >= 1e-12 keeping sign."""
    sign = np.where(d >= 0, 1.0, -1.0)
    d_safe = np.where(np.abs(d) < 1e-12, sign * 1e-12, d)
    inv = 1.0 / d_safe
    ta = (lo - o) * inv
    tb = (hi - o) * inv
    tmin = np.minimum(ta, tb).max(axis=-1)
    tmax = np.maximum(ta, tb).min(axis=-1)
    return np.maximum(tmin, 0.0), tmax


def _q16(x):
    """Round to bfloat16 (through fp32, as ml_dtypes does) and widen back:
    the engine's bf16 weights and slabs (slab_fp32=False)."""
    x = torch.from_numpy(np.ascontiguousarray(x, np.float64))
    return x.to(torch.bfloat16).to(torch.float64).numpy()


def _bilinear(slab, gx, gy, quantize=False):
    """slab: [V, V] (x, y axes); gx, gy: [...] grid coords in [0, V-1].
    With ``quantize``, weights and slab values are rounded to bf16 exactly
    as the device fast mode rounds them."""
    V = slab.shape[0]
    x0 = np.clip(np.floor(gx), 0, V - 2).astype(np.int64)
    y0 = np.clip(np.floor(gy), 0, V - 2).astype(np.int64)
    fx = np.clip(gx - x0, 0.0, 1.0)
    fy = np.clip(gy - y0, 0.0, 1.0)
    if quantize:
        slab = _q16(slab)
        w0x, w1x = _q16(1.0 - fx), _q16(fx)
        w0y, w1y = _q16(1.0 - fy), _q16(fy)
        return (w0x * (slab[x0, y0] * w0y + slab[x0, y0 + 1] * w1y)
                + w1x * (slab[x0 + 1, y0] * w0y + slab[x0 + 1, y0 + 1] * w1y))
    c00 = slab[x0, y0]
    c01 = slab[x0, y0 + 1]
    c10 = slab[x0 + 1, y0]
    c11 = slab[x0 + 1, y0 + 1]
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    return c0 + (c1 - c0) * fx


def _sample_plane(vol, zeta, gx, gy, quantize=False):
    """z-lerped slab at local plane zeta, bilinearly sampled at (gx, gy).
    vol is z-major [V(z), V(x), V(y)]."""
    V = vol.shape[0]
    gz = zeta * (V - 1)
    z0 = int(np.clip(np.floor(gz), 0, V - 2))
    fz = float(np.clip(gz - z0, 0.0, 1.0))
    slab = vol[z0] + (vol[z0 + 1] - vol[z0]) * fz
    return _bilinear(slab, gx, gy, quantize=quantize)


def render_slab_oracle(particles, volumes, camera, light, cfg, window=None,
                       light_volumes=None):
    """Render a frame (or pixel window) with slab semantics on the CPU.
    Returns [h, w, 4] float64. See module docstring for the spec."""
    r = cfg.render
    W, H = r.width, r.height
    S = r.steps
    x0w, y0w, w, h = window if window is not None else (0, 0, W, H)

    f64 = lambda a: np.asarray(a, np.float64)
    pos = f64(particles.pos)
    age, lifetime = f64(particles.age), f64(particles.lifetime)
    size, albedo = f64(particles.size), f64(particles.albedo)
    vol_idx = np.asarray(particles.vol_idx, np.int64)
    vols = np.asarray(volumes, np.float32).astype(np.float64)
    lvols = (None if light_volumes is None
             else np.asarray(light_volumes, np.float32).astype(np.float64))
    V = vols.shape[-1]

    eye, right = f64(camera.eye), f64(camera.right)
    up, fwd = f64(camera.up), f64(camera.fwd)
    sx, sy = float(camera.scale_x), float(camera.scale_y)
    l_col, l_amb = f64(light.color), f64(light.ambient)

    px, py = np.meshgrid(np.arange(x0w, x0w + w), np.arange(y0w, y0w + h))
    ndc_x = (px + 0.5) / W * 2.0 - 1.0
    ndc_y = 1.0 - (py + 0.5) / H * 2.0
    ox = ndc_x * sx
    oy = ndc_y * sy
    if cfg.camera.projection == "persp":
        d = fwd + ox[..., None] * right + oy[..., None] * up
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(eye, d.shape)
    else:
        o = eye + ox[..., None] * right + oy[..., None] * up
        d = np.broadcast_to(fwd, o.shape)

    alive = age < lifetime
    z = (pos - eye) @ fwd
    z = np.where(alive, z, np.inf)
    order = np.argsort(z, kind="stable")

    C = np.zeros((h, w, 3), np.float64)
    T = np.ones((h, w), np.float64)

    dz = d[..., 2]
    dz_safe = np.where(np.abs(dz) < _DZ_EPS,
                       np.where(dz >= 0, _DZ_EPS, -_DZ_EPS), dz)

    quantize = not r.slab_fp32
    Wn = r.slab_window
    windowed = 0 < Wn < V
    if windowed:
        # Corner rays of every screen tile (window rectangles are per
        # (tile, particle); see render/slab.py) — computed in fp32 exactly
        # like the device, so floor() agrees.
        tiles_x = W // r.tile_w
        tiles_y = H // r.tile_h
        txs = np.arange(tiles_x) * r.tile_w
        tys = np.arange(tiles_y) * r.tile_h
        cpx = (txs[None, :, None]
               + np.asarray([0, r.tile_w - 1, 0, r.tile_w - 1])[None, None])
        cpy = (tys[:, None, None]
               + np.asarray([0, 0, r.tile_h - 1, r.tile_h - 1])[None, None])
        cndc_x = ((cpx + 0.5) / W * 2.0 - 1.0).astype(np.float32)
        cndc_y = (1.0 - (cpy + 0.5) / H * 2.0).astype(np.float32)
        cox = cndc_x * np.float32(sx)
        coy = cndc_y * np.float32(sy)
        f32 = lambda a: np.asarray(a, np.float32)
        if cfg.camera.projection == "persp":
            cd = (f32(fwd) + cox[..., None] * f32(right)
                  + coy[..., None] * f32(up))
            cd = cd / np.linalg.norm(cd, axis=-1, keepdims=True)
            co = np.broadcast_to(f32(eye), cd.shape)
        else:
            co = (f32(eye) + cox[..., None] * f32(right)
                  + coy[..., None] * f32(up))
            cd = np.broadcast_to(f32(fwd), co.shape)
        cdz = cd[..., 2]
        cdz = np.where(np.abs(cdz) < _DZ_EPS,
                       np.where(cdz >= 0, _DZ_EPS, -_DZ_EPS), cdz)
        pix_ty = (py // r.tile_h)
        pix_tx = (px // r.tile_w)

    for pi in order:
        if not alive[pi]:
            break
        half = size[pi]
        ext = 2.0 * half
        lo, hi = pos[pi] - half, pos[pi] + half
        t0, t1 = _ray_aabb(o, d, lo, hi)
        seg = np.maximum(t1 - t0, 0.0)
        dt = np.minimum(ext / S / np.abs(dz_safe), seg)
        fade = _fade(age[pi] / lifetime[pi], r.fade_in, r.fade_out)
        if r.near_fade_start > 0.0:
            # camera-proximity fade, mirroring render/*'s _near_fade
            span = max(r.near_fade_start - r.near_fade_end, 1e-6)
            fade = fade * np.clip((z[pi] - r.near_fade_end) / span, 0.0, 1.0)
        scale = r.density_scale * fade
        vol = vols[vol_idx[pi]]
        lvol = None if lvols is None else lvols[vol_idx[pi]]

        if windowed:
            # per-tile window rectangle from the 8 corner-ray coords
            # (fp32, mirroring render/slab.py bit for bit)
            extf = np.float32(ext)
            gxs, gys = [], []
            for zeta_c in (np.float32(0.0), np.float32(1.0)):
                tc = (np.float32(lo[2]) + zeta_c * extf
                      - co[..., 2]) / cdz
                gxs.append((co[..., 0] + tc * cd[..., 0]
                            - np.float32(lo[0])) / extf * np.float32(V - 1))
                gys.append((co[..., 1] + tc * cd[..., 1]
                            - np.float32(lo[1])) / extf * np.float32(V - 1))
            gx_all = np.concatenate(gxs, axis=-1)
            gy_all = np.concatenate(gys, axis=-1)
            wx0_t = np.clip(np.floor(gx_all.min(axis=-1)) - 1, 0, V - Wn)
            wy0_t = np.clip(np.floor(gy_all.min(axis=-1)) - 1, 0, V - Wn)
            wx0_pix = wx0_t[pix_ty, pix_tx]
            wy0_pix = wy0_t[pix_ty, pix_tx]

        # accumulate this particle's contribution per ray, in the ray's
        # near-to-far plane order (ascending z iff dz >= 0)
        Cp_f = np.zeros((h, w, 3), np.float64)  # ascending-z front-to-back
        Cp_b = np.zeros((h, w, 3), np.float64)  # ascending-z back-to-front
        Tp = np.ones((h, w), np.float64)

        for s in range(S):
            zeta = (s + 0.5) / S
            zw = lo[2] + zeta * ext
            ts = (zw - o[..., 2]) / dz_safe
            gx = (o[..., 0] + ts * d[..., 0] - lo[0]) / ext * (V - 1)
            gy = (o[..., 1] + ts * d[..., 1] - lo[1]) / ext * (V - 1)
            inb = ((ts > 0) & (gx >= 0) & (gx <= V - 1)
                   & (gy >= 0) & (gy <= V - 1))
            if windowed:
                sgx = np.clip(gx, wx0_pix, wx0_pix + (Wn - 1))
                sgy = np.clip(gy, wy0_pix, wy0_pix + (Wn - 1))
            else:
                sgx = np.clip(gx, 0, V - 1)
                sgy = np.clip(gy, 0, V - 1)
            sigma = _sample_plane(vol, zeta, sgx, sgy,
                                  quantize=quantize) * scale
            alpha = np.where(inb, 1.0 - np.exp(-sigma * dt), 0.0)
            if lvol is not None:
                # lvol = unit-scale optical depth (volume/lightbake.py);
                # scale and world extent are applied here, matching
                # render/slab.py exactly.
                tau = _sample_plane(lvol, zeta, sgx, sgy, quantize=quantize)
                atten = np.exp(-scale * ext * np.maximum(tau, 0.0))
            else:
                atten = np.ones_like(alpha)
            c = albedo[pi] * (l_col * atten[..., None] + l_amb)
            a3 = alpha[..., None]
            Cp_f = Cp_f + (Tp * alpha)[..., None] * c
            Cp_b = a3 * c + (1.0 - a3) * Cp_b
            Tp = Tp * (1.0 - alpha)

        Cp = np.where((dz >= 0)[..., None], Cp_f, Cp_b)
        C = C + T[..., None] * Cp
        T = T * Tp

    bg = np.asarray(r.background, np.float64)
    return np.concatenate([C + T[..., None] * bg, (1.0 - T)[..., None]],
                          axis=-1)
