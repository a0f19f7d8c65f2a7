"""The warp renderer's host side (counterpart of ``volq/render/warp.py``):
per-particle shear-warp impostors, march + composite.

Per frame: rotate the scene into engine coordinates for the static
march axis (``permute_for_march``), compute each particle's rect, ray
grid and validity (``_grid_geometry``), order the particles by view
depth (a stable sort of view-z, invalid last), then

* fused (``warp_fused``, the default): kernel A (``kernel.warp_march``:
  march + fan + exp per particle) and kernel B (``kernel.
  warp_composite``: depth-ordered OVER onto the padded canvas);
* unfused (``warp_fused=False``): per depth-ordered megachunk of at most
  ``warp_mega`` particles, kernel C (``kernel.warp_images``: march + fan
  + exp + upsample into per-particle images) and kernel D (``kernel.
  composite_chunk``: OVER of the chunk onto the carried canvas);

and finish the canvas over the background (``_canvas_finish``).

Every mode of the warp engine is ported, under both projections: the
Pallas path (``warp_pallas``) through kernels A-D, static or animated
volumes, unlit, center-lit (``light_mode="center"``: one sample of the
baked light volume per ray at the particle's mid-depth step) or per-step
lit (``light_mode="march"``), fused or unfused, on a pixel canvas or the
cell canvas of ``warp_coarse`` / ``warp_canvas_scale``, with or without
``warp_interleave``'s association, in one piece or in ``warp_bands``
horizontal bands; and the XLA path (``warp_pallas=False``, the warp
engine's default) in plain torch (``warp_xla.py``), which streams the
volumes.  An orthographic camera is a compile-time mode of kernels A and
C.  Flags that change neither the image nor this path are accepted:
``warp_pair`` and ``warp_pack`` (TPU MXU-tile pairing and grid packing,
bit-identical), ``warp_canvas_vmem`` (where the TPU keeps its canvas:
storage only), ``warp_hazard_passes`` (a reorder of depth-adjacent
particles with disjoint canvas windows: no pixel's order changes),
``warp_swap_bf16`` (the wire of ``dist.sharded``'s binary swap).
The Pallas path always marches from pre-lerped slab banks.  Where the
reference streams the volumes instead (``use_slab_banks`` False:
``steps >= V`` or a block above its VMEM budget) its in-kernel lerp is
the same math with the same rounding points, so the image does not
depend on that choice; only the x-resample (``slab_vx_eff``) does.
"""
from __future__ import annotations

import numpy as np
import torch

from volq_torch.core.camera import make_camera
from volq_torch.core import trace
from volq_torch.core.device import const, scalar
from volq_torch.core.types import Camera, Light, Particles
from volq_torch.render.common import _fade, _near_fade
from volq_torch.render import kernel as K
from volq_torch.scene.config import SceneConfig

# bank entries per slab-bake chunk (bounds the fp32 lerp temporaries)
_SLAB_CHUNK = 128

# (vec perm, vol perm) candidates per march axis; see volq/render/warp.py
_MARCH_PERMS = {
    0: (((1, 2, 0), (0, 2, 3, 1)), ((2, 1, 0), (0, 2, 1, 3))),
    1: (((2, 0, 1), (0, 3, 1, 2)), ((0, 2, 1), (0, 3, 2, 1))),
    2: (((0, 1, 2), (0, 1, 2, 3)), ((1, 0, 2), (0, 1, 3, 2))),
}


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
    already z-marching with an unrolled camera); the volume bank and the
    light volumes are rotated once, when their slab banks are baked
    (``bake_slab_banks``)."""
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
    (a TPU VMEM rule).  The port's Pallas path takes slab banks whatever
    it says (the two are the same math); it gates ``warp_slab_vx``."""
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
    z0 = const([z for z, _ in consts], dev, torch.int64)
    fz = const([f for _, f in consts], dev, torch.float32)[None, :, None, None]
    resample = bool(vx) and vx != V
    if resample:
        xc = _slab_x_consts(vx, V)
        k0 = const([k for k, _ in xc], dev, torch.int64)
        fx = const([f for _, f in xc], dev,
                   torch.float32)[None, None, :, None]
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
    """World-coordinate entry point: permute the volume bank(s) into
    engine coordinates for the march axis and bake their marching slabs
    (same x-extent, same working type).  Returns (density, light or
    None); the light bank is baked when ``light_volumes`` is given and
    ``light_steps > 0``.  Cache it across frames for static scenes.
    None on the XLA path (``warp_pallas=False``), which streams the
    volumes, as the reference's ``use_slab_banks`` rules."""
    with trace.span("volq.bake.slabs"):
        r = cfg.render
        if not r.warp_pallas:
            return None
        V = volumes.shape[-1]
        _, ap = _march_perm(cfg)
        lit = light_volumes is not None and r.light_steps > 0
        if ap != (0, 1, 2, 3):
            volumes = volumes.permute(ap)
            if lit:
                light_volumes = light_volumes.permute(ap)
        wdt = torch.float32 if r.warp_fp32 else torch.bfloat16
        vx = slab_vx_eff(cfg, V)
        return (bake_march_slabs(volumes, r.steps, wdt, vx),
                bake_march_slabs(light_volumes, r.steps, wdt, vx) if lit
                else None)


def upsample_weights(RP: int, RM: int):
    """Constant hat-weight pair (Uy [RP, RM], Ux [RM, RP], numpy fp32)
    resampling the endpoint-aligned RM march grid to the RP rect: rect
    cell i reads march coordinate i * (RM-1)/(RP-1).  The kernels form
    the two non-zero taps of each row themselves; this dense form is the
    reference the tests hold ``kernel._upsample_plain`` to."""
    ratio = np.float32(RM - 1) / np.float32(RP - 1)
    p = (np.arange(RP, dtype=np.float32) * ratio)[:, None]
    m = np.arange(RM, dtype=np.float32)[None, :]
    Uy = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(p - m))
    return Uy, np.ascontiguousarray(Uy.T)


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


def _fwd_slopes(camera: Camera):
    """Orthographic ray slopes (kx, ky) = (fwd_x, fwd_y) / fwd_z, fwd_z
    kept away from 0."""
    fz = K._sign_eps(camera.fwd[2])
    return camera.fwd[0] / fz, camera.fwd[1] / fz


def ray_coords(camera: Camera, px, py, W, H, projection: str):
    """Ray coordinates (rx, ry) of the pixel rays through (px + .5,
    py + .5), fp32 elementwise: perspective, the slopes (dx/dz, dy/dz)
    of the eye ray; orthographic, the ray's (x, y) intercept with the
    z = 0 plane."""
    ndx = (px + 0.5) / scalar(W, px) * 2.0 - 1.0
    ndy = 1.0 - (py + 0.5) / scalar(H, py) * 2.0
    ox = ndx * camera.scale_x
    oy = ndy * camera.scale_y
    if projection == "persp":
        dx = camera.fwd[0] + ox * camera.right[0] + oy * camera.up[0]
        dy = camera.fwd[1] + ox * camera.right[1] + oy * camera.up[1]
        dz = K._sign_eps(camera.fwd[2] + ox * camera.right[2]
                       + oy * camera.up[2])
        return dx / dz, dy / dz
    # o = eye + ox*right + oy*up, d = fwd; intercept at z = 0
    o_x = camera.eye[0] + ox * camera.right[0] + oy * camera.up[0]
    o_y = camera.eye[1] + ox * camera.right[1] + oy * camera.up[1]
    o_z = camera.eye[2] + ox * camera.right[2] + oy * camera.up[2]
    kx, ky = _fwd_slopes(camera)
    return o_x - o_z * kx, o_y - o_z * ky


def _plane_pos_coeffs(camera: Camera, projection: str):
    """pos_x(zw) = c0x(zw) + c1x(zw) * rx (the same for y): a function
    zw -> (c0x, c1x, c0y, c1y)."""
    if projection == "persp":
        def coeffs(zw):
            c1 = zw - camera.eye[2]
            return (camera.eye[0].expand_as(zw), c1,
                    camera.eye[1].expand_as(zw), c1)
        return coeffs
    kx, ky = _fwd_slopes(camera)

    def coeffs(zw):
        one = torch.ones_like(zw)
        return zw * kx, one, zw * ky, one
    return coeffs


def _project(vx, vy, vz, camera: Camera, persp: bool, W: int, H: int):
    """Screen position (px, py) of view-space points."""
    if persp:
        vz = torch.clamp(vz, min=1e-3)
        return ((vx / (vz * camera.scale_x) + 1.0) * (0.5 * W),
                (1.0 - vy / (vz * camera.scale_y)) * (0.5 * H))
    return ((vx / camera.scale_x + 1.0) * (0.5 * W),
            (1.0 - vy / camera.scale_y) * (0.5 * H))


def _grid_geometry(particles: Particles, camera: Camera, cfg: SceneConfig,
                   y_start: int, h_local: int):
    """Per-particle validity, rect origin, grid ray coordinates and
    screen-center projection (both projections).  Returns (dict of [N] /
    [N, RM] tensors, stats dict of 0-d int32 tensors)."""
    r = cfg.render
    RP = r.warp_rect
    W, H = r.width, r.height
    proj = cfg.camera.projection
    persp = proj == "persp"
    pos = particles.pos.to(torch.float32)
    half = particles.size.to(torch.float32)

    rel = pos - camera.eye
    vx = _dot3(rel, camera.right)
    vy = _dot3(rel, camera.up)
    vz = _dot3(rel, camera.fwd)
    px_c, py_c = _project(vx, vy, vz, camera, persp, W, H)
    if persp:
        in_front = vz > 1e-3
        dzp = pos[:, 2] - camera.eye[2]
        szn = torch.where(dzp >= 0, 1.0, -1.0)
        straddle = torch.abs(dzp) <= half * 1.05
    else:
        in_front = torch.ones_like(vz, dtype=torch.bool)
        szn = torch.where(camera.fwd[2] >= 0, 1.0, -1.0).expand_as(vz)
        straddle = torch.zeros_like(vz, dtype=torch.bool)

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
                         W, H, proj)
    _, ry_w = ray_coords(camera, (px_c[:, None] - 0.5).expand_as(pyw), pyw,
                         W, H, proj)

    # footprint overflow (conservative corner-projection rect)
    signs = const([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                   for sz in (-1, 1)], pos.device, torch.float32)
    corners = pos[:, None, :] + half[:, None, None] * signs[None]
    crel = corners - camera.eye
    cpx, cpy = _project(_dot3(crel, camera.right), _dot3(crel, camera.up),
                        _dot3(crel, camera.fwd), camera, persp, W, H)
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
    """Each particle's canvas placement origin (ayf, axf: pad + rect
    origin * ratio, fp32, fractional on a cell canvas) and the corner
    (oy rows, ox x-units) of the aligned canvas window the reference's
    kernel updates for it.  (The reference returns ox in array elements,
    ``e`` per x unit.)"""
    f32 = torch.float32
    ayf = float(cg.pad) + (sy0.to(f32) - float(y_start)) * cg.ratio
    axf = float(cg.pad) + sx0.to(f32) * cg.ratio
    oy = torch.clamp(torch.floor(ayf).to(torch.int32), 0, cg.Hc - cg.WH)
    oy = torch.div(oy, 8, rounding_mode="floor") * 8
    ox = torch.clamp(torch.floor(axf).to(torch.int32), 0,
                     (cg.Wc - cg.WW) // cg.e)
    ox = torch.div(ox, cg.gx, rounding_mode="floor") * cg.gx
    return ayf, axf, oy, ox


def placement_boxes(ayf, axf, oy, ox, cg: K.CanvasGeom, c2m: float):
    """[N, 4] int32 (y0, y1, x0, x1): the canvas cells kernel B lets each
    particle touch.  On a pixel canvas the RP x RP rect at (ayf, axf);
    on a cell canvas a box generous enough for the hat tent (the tent,
    not the box, decides the weights: ``1 / c2m`` cells leak past each
    end of the placed content).  Either is cut to the window the
    reference's kernel reads and writes -- rows [oy, oy + WH), columns
    [ox, ox + WW / e), or only the window's first WWA / e columns where
    the reference skips the rest (its ``wide`` flag) -- which binds only
    where the reference itself drops a sliver of the tent."""
    fy = torch.floor(ayf).to(torch.int32)
    fx = torch.floor(axf).to(torch.int32)
    if cg.cells:
        leak = int(np.ceil(1.0 / c2m))
        lo, hi = -leak, cg.sup + leak + 1
    else:
        lo, hi = 0, cg.cu
    wide = cg.e * ((axf - ox.to(torch.float32)) + cg.sup) > cg.WWA
    ww = torch.where(wide, cg.WW // cg.e, cg.WWA // cg.e).to(torch.int32)
    return torch.stack([torch.maximum(fy + lo, oy),
                        torch.minimum(fy + hi, oy + cg.WH),
                        torch.maximum(fx + lo, ox),
                        torch.minimum(fx + hi, ox + ww)], dim=1).contiguous()


def _cell_upsample(X, P: int, ratio: float, dim: int):
    """Bilinear cell -> pixel upsample of X along ``dim`` to P pixels:
    pixel p reads cell position p * ratio through hat weights (the
    reference's ``_coarse_up_weights`` product; each weight row has two
    non-zero taps, gathered here, products and sum in fp32)."""
    Cn = X.shape[dim]
    pos = torch.arange(P, dtype=torch.float32, device=X.device) * ratio
    c0, w0, w1 = K._taps(pos, Cn, torch.float32)
    shape = [1] * X.dim()
    shape[dim] = P
    return (X.index_select(dim, c0) * w0.reshape(shape)
            + X.index_select(dim, (c0 + 1).clamp(max=Cn - 1))
            * w1.reshape(shape))


def _canvas_finish(C, T, cfg: SceneConfig, h_local: int, cropped=False):
    """Crop the padded canvas and compose over the background ->
    [h_local, W, 4] fp32 (premultiplied RGB, alpha).  A cell canvas
    (warp_coarse / warp_canvas_scale) is first upsampled to pixels, rows
    then columns, one pass per frame.  ``cropped``: the canvas starts at
    the image (the sharded frame crops the padding before its binary
    swap)."""
    with trace.span("volq.render.finish"):
        r = cfg.render
        g = K.canvas_geom(cfg, h_local)
        p0 = 0 if cropped else g.pad
        X = torch.cat([C, T[None]], dim=0)[
            :, p0:p0 + g.hc_img, p0:p0 + g.wc_img].to(torch.float32)
        if g.cells:
            X = _cell_upsample(X, h_local, g.ratio, 1)
            X = _cell_upsample(X, r.width, g.ratio, 2)
        C, T = X[:3], X[3]
        bg = const(r.background, C.device, torch.float32)[:, None, None]
        rgb = C + T[None] * bg
        return torch.cat([rgb, (1.0 - T)[None]], dim=0).permute(1, 2, 0)


def _depth_order(geom):
    """Composite order: ascending view depth, invalid particles last
    (stable)."""
    z = torch.where(geom["valid"], geom["vz"],
                    torch.full_like(geom["vz"], float("inf")))
    return torch.argsort(z, stable=True)


def _take(particles: Particles, geom, ids):
    return (particles._replace(**{f: getattr(particles, f)[ids]
                                  for f in Particles._fields}),
            {k: v[ids] for k, v in geom.items()})


def light_mode(cfg: SceneConfig, lbank) -> int:
    """``kernel.MarchParams.lit`` for a march with (or without) the light
    slab bank: the per-step lit march walks each particle's steps front
    to back, reversed where ``szn < 0`` (the kernels read the flag from
    ``pgeom[:, PG_SZN]``)."""
    if lbank is None:
        return K.UNLIT
    return K.CENTER if cfg.render.light_mode == "center" else K.PERSTEP


def _march_inputs(po: Particles, go, camera: Camera, cfg: SceneConfig,
                  bank, lbank):
    """The argument tuple of ``kernel.warp_march`` for the particles
    ``po`` with geometry ``go`` (engine coordinates, any order)."""
    r = cfg.render
    N = po.age.shape[0]
    dev = po.pos.device
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
    mp = K.march_params(N, r.steps, bank.shape[2], bank.shape[-1],
                        march_rect(cfg), r.warp_rect, r.warp_shift_max,
                        needs_row_fan(cfg), r.width, r.height,
                        lit=light_mode(cfg, lbank),
                        ortho=cfg.camera.projection == "ortho")
    return (bank.contiguous(), po.vol_idx.to(torch.int32), pgeom,
            go["rx_u"].contiguous(), go["ry_w"].contiguous(), camf, mp,
            None if lbank is None else lbank.contiguous())


def fused_inputs(particles: Particles, camera: Camera, light: Light,
                 cfg: SceneConfig, bank, y_start: int, h_local: int,
                 lbank=None):
    """Everything kernels A and B take for one frame, in depth order;
    ``lbank`` (the light slab bank) switches the lit mode on (center or
    per-step, ``cfg.render.light_mode``).
    Returns (march args tuple, composite args tuple -- without the
    canvas --, stats)."""
    with trace.span("volq.render.prep"):
        r = cfg.render
        N = particles.age.shape[0]
        particles, camera = permute_for_march(particles, camera, cfg)
        geom, stats = _grid_geometry(particles, camera, cfg, y_start, h_local)
        po, go = _take(particles, geom, _depth_order(geom))
        march = _march_inputs(po, go, camera, cfg, bank, lbank)

        RP, RM = r.warp_rect, march_rect(cfg)
        f32 = torch.float32
        lit = lbank is not None
        cg = K.canvas_geom(cfg, h_local)
        c2m = K.cell_to_march(cg, RM, RP)
        ayf, axf, oy, ox = _window_corners(go["sy0"], go["sx0"], cg, y_start)
        box = placement_boxes(ayf, axf, oy, ox, cg, c2m)
        alb = po.albedo.to(f32)
        if lit:
            cc, cc2 = alb * light.color[None], alb * light.ambient[None]
        else:
            cc, cc2 = alb * (light.color + light.ambient)[None], None
        wdt = f32 if r.warp_fp32 else torch.bfloat16
        pdt = f32 if RM == RP and not cg.cells else wdt
        cp = K.composite_params(N, RM, cg.Hc, cg.Wx,
                                c2m if cg.cells else K._ratio_m(RM, RP),
                                lit, cg.ilv)
        comp = (ayf, axf, box, cc.contiguous(), go["valid"].to(torch.int32),
                cp, pdt, None if cc2 is None else cc2.contiguous())
        return march, comp, stats


def mega_chunk(cfg: SceneConfig, N: int) -> int:
    """Particles per megachunk of the unfused path: the largest divisor
    of N not above ``warp_mega`` (N when ``warp_mega`` is 0)."""
    C = N
    if cfg.render.warp_mega > 0:
        C = min(cfg.render.warp_mega, N)
        while N % C:
            C -= 1
    return C


def unfused_inputs(particles: Particles, camera: Camera, light: Light,
                   cfg: SceneConfig, bank, y_start: int, h_local: int,
                   lbank=None):
    """Everything kernels C and D take for one frame: one (images args
    tuple, composite args tuple -- without canvas and images --) per
    depth-ordered megachunk, and the stats.  The reference marches a
    streamed shared bank in vol-idx-sorted order (a DMA dedup) and
    composites through a permutation; here every chunk is marched in
    depth order, except that a single chunk is marched as stored and
    composited through ``order``, as the reference's one-chunk fast path
    does."""
    with trace.span("volq.render.prep"):
        r = cfg.render
        N = particles.age.shape[0]
        dev = particles.pos.device
        particles, camera = permute_for_march(particles, camera, cfg)
        geom, stats = _grid_geometry(particles, camera, cfg, y_start, h_local)
        order = _depth_order(geom)
        C = mega_chunk(cfg, N)
        RP = r.warp_rect
        WH, WW, Hc, Wc = K._canvas_dims(cfg, h_local)
        lightf = torch.cat([light.color, light.ambient]).to(torch.float32)
        chunks = []
        for m in range(N // C):
            if N == C:
                pm, gm, comp_order = particles, geom, order.to(torch.int32)
            else:
                pm, gm = _take(particles, geom, order[m * C:(m + 1) * C])
                comp_order = None
            march = _march_inputs(pm, gm, camera, cfg, bank, lbank)
            oy = torch.clamp(gm["sy0"] - y_start + RP, 0, Hc - WH)
            ox = torch.clamp(gm["sx0"] + RP, 0, Wc - WW)
            chunks.append((
                march[:7] + (pm.albedo.to(torch.float32).contiguous(), lightf,
                             march[7]),
                (oy.to(torch.int32), ox.to(torch.int32), comp_order,
                 K.ChunkParams(n=C, RP=RP, Hc=Hc, Wc=Wc))))
        return chunks, stats


def render_warp_canvas(particles: Particles, volumes, camera: Camera,
                       light: Light, cfg: SceneConfig, light_volumes=None,
                       y_start: int = 0, h_local: int | None = None,
                       slab_banks=None):
    """March + composite the particles onto a fresh padded canvas,
    without the final crop.  Returns (canvas [4, Hc, Wc] -- premultiplied
    C in [:3], T in [3] --, stats).  ``light_volumes`` (the baked light
    optical depth, ``volume.lightbake``) switches the lit march on when
    ``light_steps > 0`` (center or per-step, ``light_mode``); with
    ``warp_coarse`` / ``warp_canvas_scale`` the canvas is in cells
    (``kernel.CanvasGeom``); with ``warp_fused=False`` the particles go
    through depth-sorted megachunks of at most ``warp_mega`` (march a
    chunk into images, composite it onto the carried canvas, next
    chunk); with ``warp_pallas=False`` the XLA path does the same in
    plain torch (``warp_xla.render_warp_canvas_xla``, which takes no
    slab banks).

    Stats: alive, rendered, straddled, rect_overflow, shift_clamped, all
    exact.  The reference's ``win_hazard``, ``pair_defer`` and
    ``pair_inactive`` count stalls and envelope misses of its TPU window
    pipeline and MXU pairing (they depend on VMEM residency) and have no
    counterpart here.  ``warp_pair``'s composite reorder
    (``_pair_swap_order``) and ``warp_hazard_passes``' (``_hazard_swap_
    order``) only swap depth-adjacent particles whose canvas windows are
    disjoint, so no pixel's order changes and the image is the
    unreordered one; ``warp_canvas_vmem`` moves the TPU's canvas into
    on-chip memory, storage only.  All three are accepted and change
    nothing here."""
    r = cfg.render
    if h_local is None:
        h_local = r.height
    if light_volumes is not None and r.light_steps <= 0:
        light_volumes = None       # no light march requested: unlit
    if not r.warp_pallas:
        from volq_torch.render.warp_xla import render_warp_canvas_xla
        return render_warp_canvas_xla(particles, volumes, camera, light,
                                      cfg, light_volumes, y_start, h_local)
    if slab_banks is None:
        slab_banks = bake_slab_banks(volumes, light_volumes, cfg)
    bank = slab_banks[0]
    lbank = slab_banks[1] if light_volumes is not None else None
    if light_volumes is not None and lbank is None:
        raise ValueError("a lit render needs the light slab bank: bake "
                         "slab_banks with the light volumes")
    dev = particles.pos.device
    if r.warp_fused:
        march, comp, stats = fused_inputs(particles, camera, light, cfg,
                                          bank, y_start, h_local, lbank)
        with trace.span("volq.render.march"):
            Pm, clamp = K.warp_march(*march)
        with trace.span("volq.render.composite"):
            canvas = K.canvas_init(cfg, h_local, dev)
            canvas = K.warp_composite(canvas, Pm, *comp)
        return canvas, dict(stats, shift_clamped=clamp[0])
    chunks, stats = unfused_inputs(particles, camera, light, cfg, bank,
                                   y_start, h_local, lbank)
    with trace.span("volq.render.composite"):
        canvas = K.canvas_init(cfg, h_local, dev, fused=False)
    shift_clamped = torch.zeros((), dtype=torch.int32, device=dev)
    for img_args, comp_args in chunks:
        with trace.span("volq.render.march"):
            images, clamp = K.warp_images(*img_args)
        with trace.span("volq.render.composite"):
            canvas = K.composite_chunk(canvas, images, *comp_args)
        shift_clamped = shift_clamped + clamp[0]
    return canvas, dict(stats, shift_clamped=shift_clamped)


def _merge_band_stats(a, b):
    """Counters sum across bands (a particle straddling a boundary
    renders in each band it touches, so ``rendered`` counts render
    slots); ``alive`` is scene-global and the same in every band."""
    return {k: (v if k == "alive" else v + b[k]) for k, v in a.items()}


def render_warp(particles: Particles, volumes, camera: Camera, light: Light,
                cfg: SceneConfig, light_volumes=None, y_start: int = 0,
                h_local: int | None = None, slab_banks=None):
    """Render one frame (or a horizontal pixel band of it) with the warp
    engine.  Returns ([h_local, W, 4] fp32 image, stats).

    ``warp_bands > 1`` renders the frame as that many horizontal bands
    of ``height // bands`` (+ 1) rows, each through its own canvas and
    kernel launches, and stacks the rows: the bands hold disjoint
    pixels and per-pixel compositing is the same math, so the image is
    exactly the unbanded one.  The slab banks are baked once for all
    bands."""
    r = cfg.render
    if h_local is None:
        h_local = r.height
    if light_volumes is not None and r.light_steps <= 0:
        light_volumes = None       # no light march requested: unlit
    bands = int(r.warp_bands)
    if bands > 1 and y_start == 0 and h_local == r.height:
        if slab_banks is None:
            slab_banks = bake_slab_banks(volumes, light_volumes, cfg)
        rows, stats, y0 = [], None, 0
        for i in range(bands):
            bh = r.height // bands + (1 if i < r.height % bands else 0)
            img, st = render_warp(particles, volumes, camera, light, cfg,
                                  light_volumes=light_volumes, y_start=y0,
                                  h_local=bh, slab_banks=slab_banks)
            rows.append(img)
            stats = st if stats is None else _merge_band_stats(stats, st)
            y0 += bh
        return torch.cat(rows, dim=0), stats
    canvas, stats = render_warp_canvas(particles, volumes, camera, light,
                                       cfg, light_volumes=light_volumes,
                                       y_start=y_start, h_local=h_local,
                                       slab_banks=slab_banks)
    return _canvas_finish(canvas[:3], canvas[3], cfg, h_local), stats
