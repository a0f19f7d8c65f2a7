"""The warp renderer's host side (counterpart of ``volq/render/warp.py``):
per-particle shear-warp impostors, fused march + composite.

Per frame: rotate the scene into engine coordinates for the static
march axis (``permute_for_march``), compute each particle's rect, ray
grid and validity (``_grid_geometry``), order the particles by view
depth (a stable sort of view-z, invalid last), then run kernel A
(``kernel.warp_march``: march + fan + exp per particle) and kernel B
(``kernel.warp_composite``: depth-ordered OVER onto the padded canvas),
and finish the canvas over the background (``_canvas_finish``).

The slice ported so far is the production unlit mode of c3: perspective
camera, static volumes, slab banks, fused, unpaired.  ``check_supported``
raises NotImplementedError for every other mode.  Flags that change
neither the image nor this path are accepted: ``warp_pack`` (TPU grid
packing, bit-identical), ``warp_chunk`` / ``warp_mega`` (unfused-path
chunking), ``warp_swap_bf16`` (sharded wire).  The port always marches
from pre-lerped slab banks: where the reference would stream volumes
instead (``use_slab_banks`` False) its in-kernel lerp is the same math,
and only the x-resample (``slab_vx_eff``) depends on that choice.
"""
from __future__ import annotations

import numpy as np
import torch

from volq_torch.core.camera import make_camera
from volq_torch.core.device import scalar
from volq_torch.core.types import Camera, Light, Particles
from volq_torch.render.common import _fade, _near_fade
from volq_torch.render import kernel as K
from volq_torch.scene.config import SceneConfig

_EPS = 1e-6
# bank entries per slab-bake chunk (bounds the fp32 lerp temporaries)
_SLAB_CHUNK = 128

# (vec perm, vol perm) candidates per march axis; see volq/render/warp.py
_MARCH_PERMS = {
    0: (((1, 2, 0), (0, 2, 3, 1)), ((2, 1, 0), (0, 2, 1, 3))),
    1: (((2, 0, 1), (0, 3, 1, 2)), ((0, 2, 1), (0, 3, 2, 1))),
    2: (((0, 1, 2), (0, 1, 2, 3)), ((1, 0, 2), (0, 1, 3, 2))),
}


def check_supported(cfg: SceneConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for any flag
    outside the ported slice (no flag is silently ignored)."""
    r = cfg.render
    unsupported = [
        (r.engine != "warp", f"render engine {r.engine!r}",
         "Queue 1 items 10-11"),
        (not r.warp_pallas, "warp_pallas=False (the XLA warp path)",
         "Queue 1 item 5"),
        (not r.warp_fused, "warp_fused=False (unfused march + composite)",
         "Queue 2 items 2-3"),
        (r.light_steps > 0, "lit warp modes (light_steps > 0)",
         "Queue 2 item 1, Queue 1 item 3"),
        (bool(r.warp_pair), "warp_pair", "Queue 2 item 1"),
        (bool(r.warp_coarse), "warp_coarse", "Queue 2 item 1"),
        (bool(r.warp_canvas_scale), "warp_canvas_scale", "Queue 2 item 1"),
        (bool(r.warp_interleave), "warp_interleave", "Queue 2 item 1"),
        (bool(r.warp_canvas_vmem), "warp_canvas_vmem", "Queue 2 item 1"),
        (r.warp_bands > 1, "warp_bands > 1", "Queue 2 item 1"),
        (r.warp_hazard_passes > 0, "warp_hazard_passes", "Queue 2 item 1"),
        (cfg.camera.projection != "persp", "orthographic camera",
         "Queue 1 items 4-5"),
        (cfg.volume.animated, "animated (4-D) volumes", "Queue 1 item 3"),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"volq_torch does not port {what} yet (ROADMAP {item})")


def _static_camera(cfg: SceneConfig):
    return make_camera(cfg.camera.eye, cfg.camera.look_at, cfg.camera.up,
                       fov_y_deg=cfg.camera.fov_y_deg, aspect=1.0,
                       ortho_half_h=cfg.camera.ortho_half_h,
                       projection=cfg.camera.projection)


def march_axis(cfg: SceneConfig) -> int:
    """World axis (0=x, 1=y, 2=z) most aligned with the camera forward."""
    cam = _static_camera(cfg)
    f = [abs(float(cam.fwd[i])) for i in range(3)]
    return int(max(range(3), key=lambda i: f[i]))


def _march_perm(cfg: SceneConfig):
    """Static (vec perm, vol perm) for the march axis, the candidate that
    best aligns camera right -> engine x and up -> engine y."""
    cam = _static_camera(cfg)

    def score(vp):
        return abs(float(cam.right[vp[0]])) + abs(float(cam.up[vp[1]]))

    return max(_MARCH_PERMS[march_axis(cfg)],
               key=lambda cand: score(cand[0]))


def permute_for_march(particles: Particles, camera: Camera,
                      cfg: SceneConfig):
    """Rotate particles and camera into engine coordinates (identity when
    already z-marching with an unrolled camera); the volume bank is
    rotated once, when its slab banks are baked (``bake_slab_banks``)."""
    vp, _ = _march_perm(cfg)
    if vp == (0, 1, 2):
        return particles, camera
    v = list(vp)
    particles = particles._replace(pos=particles.pos[:, v],
                                   vel=particles.vel[:, v])
    camera = camera._replace(eye=camera.eye[v], right=camera.right[v],
                             up=camera.up[v], fwd=camera.fwd[v])
    return particles, camera


def _march_z_consts(S: int, V: int):
    """Static (z0, fz) z-lerp constants of every marching step (fp32
    arithmetic of the reference)."""
    gsc = np.float32(V - 1)
    out = []
    for s in range(S):
        zeta = (np.float32(s) + np.float32(0.5)) / np.float32(S)
        gz = zeta * gsc
        z0f = np.clip(np.float32(np.floor(gz)), np.float32(0.0),
                      np.float32(V - 2))
        fz = np.clip(gz - z0f, np.float32(0.0), np.float32(1.0))
        out.append((int(z0f), float(fz)))
    return out


def _slab_x_consts(VX: int, V: int):
    """Static (k0, fx) align-corners x-resample constants."""
    out = []
    for i in range(VX):
        p = np.float32(i) * np.float32(V - 1) / np.float32(VX - 1)
        k0 = np.clip(np.float32(np.floor(p)), np.float32(0.0),
                     np.float32(V - 2))
        f = np.clip(p - k0, np.float32(0.0), np.float32(1.0))
        out.append((int(k0), float(f)))
    return out


def use_slab_banks(cfg: SceneConfig, V: int) -> bool:
    """The reference's choice of pre-lerped banks over streamed volumes
    (a TPU VMEM rule); in the port it only gates ``warp_slab_vx``."""
    r = cfg.render
    if not r.warp_pallas or r.engine != "warp":
        return False
    itemsize = 4 if r.warp_fp32 else 2
    lit = r.light_steps > 0
    block = r.steps * V * V * itemsize
    return r.steps < V and (1 + lit) * 2 * block <= 9 * 2 ** 20


def slab_vx_eff(cfg: SceneConfig, V: int) -> int:
    """x-extent of the baked slab banks: warp_slab_vx where the reference
    applies it (slab banks in use, telescoped march), else V."""
    r = cfg.render
    vx = r.warp_slab_vx
    if vx <= 0 or vx >= V or not use_slab_banks(cfg, V):
        return V
    if r.light_steps > 0 and r.light_mode != "center":
        return V
    return vx


def bake_march_slabs(volumes, S: int, dtype, vx: int = 0):
    """[M, V, V, V] (engine coordinates) -> pre-lerped marching slabs
    [M, S, vx or V, V]: slab[m, s] = vol[m, z0_s] + (vol[m, z0_s+1] -
    vol[m, z0_s]) * fz_s in fp32, optionally x-resampled to vx points by
    the same lerp, cast to ``dtype``.  Baked in chunks of entries to
    bound the fp32 temporaries."""
    M, V = volumes.shape[0], volumes.shape[-1]
    dev = volumes.device
    consts = _march_z_consts(S, V)
    z0 = torch.tensor([z for z, _ in consts], device=dev)
    fz = torch.tensor([f for _, f in consts], dtype=torch.float32,
                      device=dev)[None, :, None, None]
    resample = bool(vx) and vx != V
    if resample:
        xc = _slab_x_consts(vx, V)
        k0 = torch.tensor([k for k, _ in xc], device=dev)
        fx = torch.tensor([f for _, f in xc], dtype=torch.float32,
                          device=dev)[None, None, :, None]
    out = torch.empty((M, S, vx if resample else V, V), dtype=dtype,
                      device=dev)
    for c0 in range(0, M, _SLAB_CHUNK):
        vol = volumes[c0:c0 + _SLAB_CHUNK]
        a = vol.index_select(1, z0).to(torch.float32)
        b = vol.index_select(1, z0 + 1).to(torch.float32)
        bank = a + (b - a) * fz
        if resample:
            ka = bank.index_select(2, k0)
            kb = bank.index_select(2, k0 + 1)
            bank = ka + (kb - ka) * fx
        out[c0:c0 + _SLAB_CHUNK] = bank.to(dtype)
    return out


def bake_slab_banks(volumes, light_volumes, cfg: SceneConfig):
    """World-coordinate entry point: permute the bank into engine
    coordinates for the march axis and bake its marching slabs.  Returns
    (density, None) (the light bank belongs to the lit modes, not ported).
    Cache it across frames for static scenes."""
    check_supported(cfg)
    V = volumes.shape[-1]
    _, ap = _march_perm(cfg)
    if ap != (0, 1, 2, 3):
        volumes = volumes.permute(ap)
    wdt = torch.float32 if cfg.render.warp_fp32 else torch.bfloat16
    return (bake_march_slabs(volumes, cfg.render.steps, wdt,
                             slab_vx_eff(cfg, V)), None)


def march_rect(cfg: SceneConfig) -> int:
    """March-grid resolution RM (== warp_rect unless warp_march_rect is
    set below it)."""
    r = cfg.render
    RM = r.warp_march_rect
    if not RM or RM >= r.warp_rect:
        return r.warp_rect
    return RM


def needs_row_fan(cfg: SceneConfig) -> bool:
    """True when the camera, in engine coordinates, is yawed or rolled
    (the row ray coordinate then depends on the column)."""
    cam = _static_camera(cfg)
    vp, _ = _march_perm(cfg)
    right = [float(cam.right[i]) for i in vp]
    up = [float(cam.up[i]) for i in vp]
    return bool(abs(right[2]) > 1e-6 or abs(right[1]) > 1e-6
                or abs(up[0]) > 1e-6)


def _dot3(a, v):
    """a [..., 3] . v [3], summed in the reference's order."""
    return a[..., 0] * v[0] + a[..., 1] * v[1] + a[..., 2] * v[2]


def ray_coords(camera: Camera, px, py, W, H):
    """Perspective ray coordinates (dx/dz, dy/dz) of the pixel rays
    through (px + .5, py + .5), fp32 elementwise."""
    ndx = (px + 0.5) / scalar(W, px) * 2.0 - 1.0
    ndy = 1.0 - (py + 0.5) / scalar(H, py) * 2.0
    ox = ndx * camera.scale_x
    oy = ndy * camera.scale_y
    dx = camera.fwd[0] + ox * camera.right[0] + oy * camera.up[0]
    dy = camera.fwd[1] + ox * camera.right[1] + oy * camera.up[1]
    dz = camera.fwd[2] + ox * camera.right[2] + oy * camera.up[2]
    eps = torch.where(dz >= 0, _EPS, -_EPS)
    dz = torch.where(torch.abs(dz) < _EPS, eps, dz)
    return dx / dz, dy / dz


def _grid_geometry(particles: Particles, camera: Camera, cfg: SceneConfig,
                   y_start: int, h_local: int):
    """Per-particle validity, rect origin, grid ray coordinates and
    screen-center projection (perspective).  Returns (dict of [N] /
    [N, RM] tensors, stats dict of 0-d int32 tensors)."""
    r = cfg.render
    RP = r.warp_rect
    W, H = r.width, r.height
    pos = particles.pos.to(torch.float32)
    half = particles.size.to(torch.float32)

    rel = pos - camera.eye
    vx = _dot3(rel, camera.right)
    vy = _dot3(rel, camera.up)
    vz = _dot3(rel, camera.fwd)
    vz_safe = torch.clamp(vz, min=1e-3)
    px_c = (vx / (vz_safe * camera.scale_x) + 1.0) * (0.5 * W)
    py_c = (1.0 - vy / (vz_safe * camera.scale_y)) * (0.5 * H)
    in_front = vz > 1e-3
    dzp = pos[:, 2] - camera.eye[2]
    szn = torch.where(dzp >= 0, 1.0, -1.0)
    straddle = torch.abs(dzp) <= half * 1.05

    alive = particles.age < particles.lifetime
    sx0 = (torch.round(px_c) - RP // 2).to(torch.int32)
    sy0 = (torch.round(py_c) - RP // 2).to(torch.int32)
    on_screen = ((sx0 > -RP) & (sx0 < W)
                 & (sy0 > y_start - RP) & (sy0 < y_start + h_local))
    valid = alive & in_front & on_screen
    if r.near_fade_start > 0.0:
        valid = valid & (vz > r.near_fade_end)

    tau_life = particles.age / torch.clamp(particles.lifetime, min=1e-6)
    scale = (r.density_scale * _fade(tau_life, r.fade_in, r.fade_out)
             * _near_fade(vz, r))

    # column u samples pixel (sx0 + u*spacing) at the continuous center
    # row py_c; row w samples pixel row (sy0 + w*spacing) at px_c
    RM = march_rect(cfg)
    uu = torch.arange(RM, dtype=torch.float32, device=pos.device) \
        * float(np.float32((RP - 1) / max(RM - 1, 1)))
    pxu = sx0[:, None].to(torch.float32) + uu[None, :]
    pyw = sy0[:, None].to(torch.float32) + uu[None, :]
    rx_u, _ = ray_coords(camera, pxu, (py_c[:, None] - 0.5).expand_as(pxu),
                         W, H)
    _, ry_w = ray_coords(camera, (px_c[:, None] - 0.5).expand_as(pyw), pyw,
                         W, H)

    # footprint overflow (conservative corner-projection rect)
    signs = torch.tensor([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                          for sz in (-1, 1)], dtype=torch.float32,
                         device=pos.device)
    corners = pos[:, None, :] + half[:, None, None] * signs[None]
    crel = corners - camera.eye
    cvx = _dot3(crel, camera.right)
    cvy = _dot3(crel, camera.up)
    cvz = torch.clamp(_dot3(crel, camera.fwd), min=1e-3)
    cpx = (cvx / (cvz * camera.scale_x) + 1.0) * (0.5 * W)
    cpy = (1.0 - cvy / (cvz * camera.scale_y)) * (0.5 * H)
    foot_w = cpx.amax(1) - cpx.amin(1)
    foot_h = cpy.amax(1) - cpy.amin(1)
    i32 = torch.int32
    stats = {
        "alive": alive.sum().to(i32),
        "rendered": valid.sum().to(i32),
        "straddled": (valid & straddle).sum().to(i32),
        "rect_overflow": (valid & ((foot_w > RP) | (foot_h > RP)))
        .sum().to(i32),
    }
    return dict(px_c=px_c, py_c=py_c, sx0=sx0, sy0=sy0, szn=szn,
                valid=valid, scale=scale, rx_u=rx_u, ry_w=ry_w, vz=vz,
                foot_w=foot_w, foot_h=foot_h), stats


def _window_corners(sy0, sx0, cg: K.CanvasGeom, y_start: int):
    """Each particle's canvas placement origin (ayf, axf) in canvas
    pixels: pad + rect origin.  (The reference also returns its TPU
    window's aligned corners; the port composites per pixel.)"""
    ayf = float(cg.pad) + (sy0.to(torch.float32) - float(y_start))
    axf = float(cg.pad) + sx0.to(torch.float32)
    return ayf, axf


def _canvas_finish(C, T, cfg: SceneConfig, h_local: int):
    """Crop the padded canvas and compose over the background ->
    [h_local, W, 4] fp32 (premultiplied RGB, alpha)."""
    r = cfg.render
    RP = r.warp_rect
    C = C[:, RP:RP + h_local, RP:RP + r.width].to(torch.float32)
    T = T[RP:RP + h_local, RP:RP + r.width].to(torch.float32)
    bg = torch.tensor(r.background, dtype=torch.float32,
                      device=C.device)[:, None, None]
    rgb = C + T[None] * bg
    return torch.cat([rgb, (1.0 - T)[None]], dim=0).permute(1, 2, 0)


def fused_inputs(particles: Particles, camera: Camera, light: Light,
                 cfg: SceneConfig, bank, y_start: int, h_local: int):
    """Everything the two kernels take for one frame, in depth order.
    Returns (march args tuple, composite args tuple -- without the
    canvas --, stats)."""
    r = cfg.render
    N = particles.age.shape[0]
    dev = particles.pos.device
    particles, camera = permute_for_march(particles, camera, cfg)
    geom, stats = _grid_geometry(particles, camera, cfg, y_start, h_local)

    z = torch.where(geom["valid"], geom["vz"],
                    torch.full_like(geom["vz"], float("inf")))
    order = torch.argsort(z, stable=True)
    po = particles._replace(**{f: getattr(particles, f)[order]
                               for f in Particles._fields})
    go = {k: v[order] for k, v in geom.items()}

    RP, RM, S = r.warp_rect, march_rect(cfg), r.steps
    V = bank.shape[-1]
    f32 = torch.float32
    pos = po.pos.to(f32)
    half = po.size.to(f32)
    lo = pos - half[:, None]
    pgeom = torch.zeros((N, K.PG_N), dtype=f32, device=dev)
    pgeom[:, K.PG_LOX:K.PG_LOZ + 1] = lo
    pgeom[:, K.PG_EXT] = 2.0 * half
    pgeom[:, K.PG_SCALE] = go["scale"]
    pgeom[:, K.PG_SZN] = go["szn"]
    pgeom[:, K.PG_VALID] = go["valid"].to(f32)
    pgeom[:, K.PG_SX0] = go["sx0"].to(f32)
    pgeom[:, K.PG_SY0] = go["sy0"].to(f32)
    pgeom[:, K.PG_PXC] = go["px_c"]
    pgeom[:, K.PG_PYC] = go["py_c"]
    camf = torch.cat([camera.eye, camera.right, camera.up, camera.fwd,
                      camera.scale_x.reshape(1), camera.scale_y.reshape(1),
                      torch.zeros(2, dtype=f32, device=dev)]).to(f32)
    mp = K.march_params(N, S, bank.shape[2], V, RM, RP, r.warp_shift_max,
                        needs_row_fan(cfg), r.width, r.height)
    march = (bank.contiguous(), po.vol_idx.to(torch.int32), pgeom,
             go["rx_u"].contiguous(), go["ry_w"].contiguous(), camf, mp)

    cg = K.canvas_geom(cfg, h_local)
    ayf, axf = _window_corners(go["sy0"], go["sx0"], cg, y_start)
    cc = po.albedo.to(f32) * (light.color + light.ambient)[None]
    wdt = f32 if r.warp_fp32 else torch.bfloat16
    pdt = f32 if RM == RP else wdt
    comp = (ayf, axf, cc.contiguous(), go["valid"].to(torch.int32),
            K.composite_params(N, RM, RP, cg.Hc, cg.Wc), pdt)
    return march, comp, stats


def render_warp_canvas(particles: Particles, volumes, camera: Camera,
                       light: Light, cfg: SceneConfig, light_volumes=None,
                       y_start: int = 0, h_local: int | None = None,
                       slab_banks=None):
    """March + composite the particles onto a fresh padded canvas,
    without the final crop.  Returns (canvas [4, Hc, Wc] -- premultiplied
    C in [:3], T in [3] --, stats).  Stats: alive, rendered, straddled,
    rect_overflow, shift_clamped (the reference's ``win_hazard`` counts
    TPU window-pipeline stalls and has no counterpart here)."""
    check_supported(cfg)
    if h_local is None:
        h_local = cfg.render.height
    if slab_banks is None:
        slab_banks = bake_slab_banks(volumes, light_volumes, cfg)
    march, comp, stats = fused_inputs(particles, camera, light, cfg,
                                      slab_banks[0], y_start, h_local)
    P2m, clamp = K.warp_march(*march)
    canvas = K.canvas_init(cfg, h_local, particles.pos.device)
    canvas = K.warp_composite(canvas, P2m, *comp)
    return canvas, dict(stats, shift_clamped=clamp[0])


def render_warp(particles: Particles, volumes, camera: Camera, light: Light,
                cfg: SceneConfig, light_volumes=None, y_start: int = 0,
                h_local: int | None = None, slab_banks=None):
    """Render one frame with the warp engine.  Returns ([h_local, W, 4]
    fp32 image, stats)."""
    r = cfg.render
    if h_local is None:
        h_local = r.height
    canvas, stats = render_warp_canvas(particles, volumes, camera, light,
                                       cfg, light_volumes=light_volumes,
                                       y_start=y_start, h_local=h_local,
                                       slab_banks=slab_banks)
    return _canvas_finish(canvas[:3], canvas[3], cfg, h_local), stats
