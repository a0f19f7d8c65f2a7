"""The slab engine (counterpart of ``volq/render/slab.py``): z-plane
quadrature, ``render.engine == "slab"``.  Plain tensor code, no kernel.

The sampling spec is the reference's (and its oracle's,
``volq/oracle/slab_cpu.py``):

  * ``steps`` planes at fixed LOCAL z of each particle's box,
    zeta_s = (s + 0.5) / steps; a ray samples plane s where it crosses it
    (t_s = (z_s - o.z) / d.z, |d.z| kept >= 1e-6) and the sample counts
    iff t_s > 0 and its in-plane coordinates lie inside the volume;
  * dt = plane spacing along the ray, min(ext / steps / |d.z|, seg), seg
    being the slab-test segment;
  * the density at a sample is the bilinear interpolation of the z-lerped
    slab (the two volume slices around zeta), through hat weights;
  * planes are visited in ascending z: front to back for rays with
    d.z >= 0, back to front otherwise -- both accumulators are kept and
    each ray takes its own;
  * ``slab_window`` clamps the in-plane coordinates into a window of that
    many voxels per (tile, particle), placed from the tile's four corner
    rays at the box's near and far z faces;
  * ``slab_fp32=False`` rounds the z-lerped slab and the hat weights to
    bf16; the products sum in fp32;
  * lighting samples the baked light optical depth (``volume.lightbake``)
    at the same points.

The reference contracts dense hat-weight matrices [P, tp, V] against each
slab on the TPU's matrix unit, because the TPU has no fast gather.  A hat
weight row has two non-zero taps, so here each sample gathers its four
slab cells (each the lerp of two bank voxels, rounded where the
reference rounds its slab) and sums the two taps of each axis in the
reference's order, x then y.  That is the same value for every bank
size, so the reference's three fetch routes (shared bank, one-hot up to
``ONEHOT_MAX_BANK``, row gather) are one route here; the light pass runs
in the march's step loop, on the same weights.  ``slab_pair_chunk``
bounds the per-chunk workspace and does not change the image.

``slab_grouped`` and ``slab_particle_chunk`` are accepted and change
nothing here.  The reference's grouped march walks the [N, MT] candidate
grid so that each step's slab is built once per particle and shared by
that particle's tiles; the saving is the slab's matrix-unit contraction.
Here there is no slab to share: each sample gathers its own four cells,
so a grouped march would gather exactly what the pairwise march does,
for every candidate slot, empty ones included.  Every frame takes the
pairwise march.
"""
from __future__ import annotations

import numpy as np
import torch

from volq_torch.core.aabb import ray_aabb
from volq_torch.core.camera import pixel_rays, view_z
from volq_torch.core.device import scalar
from volq_torch.core.types import Camera, Light, Particles
from volq_torch.render.binning import bin_particles, PairList
from volq_torch.render.common import _fade, _near_fade
from volq_torch.render.exact import composite_pairs, assemble_image
from volq_torch.render.kernel import _taps
from volq_torch.scene.config import SceneConfig

# the reference's bank size above which it gathers rows instead of a
# one-hot contraction (a route choice only: the image does not depend on it)
ONEHOT_MAX_BANK = 64
_DZ_EPS = 1e-6


def _largest_divisor_leq(n: int, k: int) -> int:
    for c in range(min(k, n), 0, -1):
        if n % c == 0:
            return c
    return n


def _plane(s: int, S: int, V: int):
    """(zeta, z0, fz) of plane s, in fp32 as the reference computes them."""
    f32 = np.float32
    zeta = f32(s + 0.5) / f32(S)
    g = zeta * f32(V - 1)
    z0 = int(np.clip(np.floor(g), 0, V - 2))
    fz = f32(np.clip(g - f32(z0), 0.0, 1.0))
    return float(zeta), z0, float(fz)


def _sample(bank, rows, z0: int, fz: float, jx, wx0, wx1, ky, wy0, wy1,
            n: int, x_off, y_off, wdt):
    """Bilinear sample of the z-lerped slab of bank entries ``rows`` [R]
    at plane cell (z0, fz): x taps (jx, jx + 1) with weights wx0 / wx1,
    y taps (ky, ky + 1) with wy0 / wy1, all [R, tp], on an axis of ``n``
    cells starting at voxel (x_off, y_off) [R, 1] (the window; 0 without
    one).  A tap outside [0, n) has weight 0.  Each slab cell is the fp32
    lerp of two voxels rounded to ``wdt``; the x taps sum first, then the
    y taps, in fp32.  Returns [R, tp] fp32."""
    V = bank.shape[-1]
    flat = bank.reshape(-1)
    base = (rows.to(torch.int64) * V + z0)[:, None] * (V * V)      # [R, 1]
    xa = (jx.clamp(0, n - 1) + x_off) * V
    xb = ((jx + 1).clamp(0, n - 1) + x_off) * V
    ya = ky.clamp(0, n - 1) + y_off
    yb = (ky + 1).clamp(0, n - 1) + y_off

    def cell(ix, iy):
        i = base + ix + iy
        v0 = flat[i].to(torch.float32)
        v1 = flat[i + V * V].to(torch.float32)
        return (v0 + (v1 - v0) * fz).to(wdt).to(torch.float32)

    t_a = wx0 * cell(xa, ya) + wx1 * cell(xb, ya)
    t_b = wx0 * cell(xa, yb) + wx1 * cell(xb, yb)
    return t_a * wy0 + t_b * wy1


def _march_rows(gtile, valid, pos, half, albedo, vol_rows, tau_life,
                volumes, camera: Camera, light: Light, cfg: SceneConfig,
                light_volumes=None):
    """March R (tile, particle) rows: ``gtile`` [R] global tile ids,
    ``valid`` [R], and the particle's pos [R, 3], half extent [R], albedo
    [R, 3], bank row [R] and age / lifetime [R].  Returns (C [R, tp, 3],
    T [R, tp]), premultiplied colour and transmittance, fp32."""
    r = cfg.render
    tiles_x = r.width // r.tile_w
    tiles_y = r.height // r.tile_h
    tp = r.tile_h * r.tile_w
    V = volumes.shape[-1]
    S = r.steps
    wdt = torch.float32 if r.slab_fp32 else torch.bfloat16
    dev = pos.device
    f32 = torch.float32
    i64 = dict(dtype=torch.int64, device=dev)

    scale = (r.density_scale * _fade(tau_life, r.fade_in, r.fade_out)
             * _near_fade(view_z(camera, pos), r))[:, None]       # [R, 1]
    half = half[:, None]
    gt = gtile.to(torch.int64)
    tx = gt % tiles_x
    ty = torch.clamp(torch.div(gt, tiles_x, rounding_mode="floor"),
                     max=tiles_y - 1)
    ti = torch.arange(tp, **i64)
    px = tx[:, None] * r.tile_w + (ti % r.tile_w)[None, :]
    py = ty[:, None] * r.tile_h \
        + torch.div(ti, r.tile_w, rounding_mode="floor")[None, :]
    o, d = pixel_rays(camera, px, py, r.width, r.height,
                      cfg.camera.projection)                    # [R, tp, 3]

    lo = pos[:, None, :] - half[..., None]                      # [R, 1, 3]
    hi = pos[:, None, :] + half[..., None]
    t0, t1 = ray_aabb(o, d, lo, hi)
    seg = torch.clamp(t1 - t0, min=0.0)
    pvalid = valid[:, None]

    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    dz_safe = torch.where(torch.abs(dz) < _DZ_EPS,
                          torch.where(dz >= 0, _DZ_EPS, -_DZ_EPS), dz)
    ext = 2.0 * half                                            # [R, 1]
    dt = torch.minimum(ext / scalar(S, ext) / torch.abs(dz_safe), seg)
    lo_x, lo_y, lo_z = lo[..., 0], lo[..., 1], lo[..., 2]       # [R, 1]
    gscale = V - 1

    Wn = r.slab_window
    windowed = 0 < Wn < V
    n = Wn if windowed else V
    if windowed:
        cx = torch.tensor([0, r.tile_w - 1, 0, r.tile_w - 1], **i64)
        cy = torch.tensor([0, 0, r.tile_h - 1, r.tile_h - 1], **i64)
        oc, dc = pixel_rays(camera, tx[:, None] * r.tile_w + cx,
                            ty[:, None] * r.tile_h + cy, r.width, r.height,
                            cfg.camera.projection)              # [R, 4, 3]
        dzc = dc[..., 2]
        dzc = torch.where(torch.abs(dzc) < _DZ_EPS,
                          torch.where(dzc >= 0, _DZ_EPS, -_DZ_EPS), dzc)
        gxs, gys = [], []
        for zc in (lo_z, lo_z + ext):
            tc = (zc - oc[..., 2]) / dzc                        # [R, 4]
            gxs.append((oc[..., 0] + tc * dc[..., 0] - lo_x) / ext * gscale)
            gys.append((oc[..., 1] + tc * dc[..., 1] - lo_y) / ext * gscale)

        def origin(gs):
            g = torch.floor(torch.cat(gs, dim=1).amin(dim=1)) - 1
            return torch.clamp(g, 0, V - Wn).to(torch.int64)[:, None]

        x_off, y_off = origin(gxs), origin(gys)                 # [R, 1]
        x_lo, y_lo = x_off.to(f32), y_off.to(f32)
    else:
        x_off = y_off = 0

    l_col, l_amb = light.color, light.ambient
    R = pos.shape[0]
    Cf = torch.zeros((R, tp, 3), dtype=f32, device=dev)
    Cb = torch.zeros((R, tp, 3), dtype=f32, device=dev)
    T = torch.ones((R, tp), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    for s in range(S):
        zeta, z0, fz = _plane(s, S, V)
        zw = lo_z + zeta * ext                                  # [R, 1]
        ts = (zw - oz) / dz_safe                                # [R, tp]
        gx = (ox + ts * dx - lo_x) / ext * gscale
        gy = (oy + ts * dy - lo_y) / ext * gscale
        inb = ((ts > 0) & (gx >= 0) & (gx <= gscale)
               & (gy >= 0) & (gy <= gscale))
        if windowed:
            gx = torch.minimum(torch.maximum(gx, x_lo), x_lo + (Wn - 1)) \
                - x_lo
            gy = torch.minimum(torch.maximum(gy, y_lo), y_lo + (Wn - 1)) \
                - y_lo
        else:
            gx = torch.clamp(gx, 0, gscale)
            gy = torch.clamp(gy, 0, gscale)
        taps = _taps(gx, n, wdt) + _taps(gy, n, wdt)

        def sample(bank):
            return _sample(bank, vol_rows, z0, fz, *taps, n, x_off, y_off,
                           wdt)

        alpha = torch.where(inb & pvalid,
                            1.0 - torch.exp(-(sample(volumes) * scale) * dt),
                            zero)
        if light_volumes is not None:
            # unit-scale optical depth: the extinction scale and the box's
            # world extent apply here, per particle (volume/lightbake.py)
            tau = torch.clamp(sample(light_volumes), min=0.0)
            atten = torch.exp(-scale * ext * tau)[..., None]
            c = albedo[:, None, :] * (l_col * atten + l_amb)
        else:
            c = albedo[:, None, :] * (l_col + l_amb)
        a3 = alpha[..., None]
        Cf = Cf + (T * alpha)[..., None] * c
        Cb = a3 * c + (1.0 - a3) * Cb
        T = T * (1.0 - alpha)
    return torch.where((dz >= 0)[..., None], Cf, Cb), T


def _march_pairs_slab(pairs: PairList, particles: Particles, volumes,
                      camera: Camera, light: Light, cfg: SceneConfig,
                      tile_start=0, light_volumes=None):
    """March every kept pair, ``slab_pair_chunk`` pairs at a time (the
    largest divisor of the pair count not above it; 0: one chunk).
    Returns (C [P, tp, 3], T [P, tp])."""
    P = pairs.pid.shape[0]
    chunk = cfg.render.slab_pair_chunk
    chunk = _largest_divisor_leq(P, chunk) if 0 < chunk < P else P
    gtile = pairs.tile + torch.as_tensor(tile_start, dtype=torch.int32,
                                         device=pairs.tile.device)
    Cs, Ts = [], []
    for c0 in range(0, P, chunk):
        pid = pairs.pid[c0:c0 + chunk].long()
        C, T = _march_rows(
            gtile[c0:c0 + chunk], pairs.valid[c0:c0 + chunk],
            particles.pos[pid], particles.size[pid], particles.albedo[pid],
            particles.vol_idx[pid],
            particles.age[pid] / torch.clamp(particles.lifetime[pid],
                                             min=1e-6),
            volumes, camera, light, cfg, light_volumes)
        Cs.append(C)
        Ts.append(T)
    return torch.cat(Cs), torch.cat(Ts)


def render_slab_tiles(particles: Particles, volumes, camera: Camera,
                      light: Light, cfg: SceneConfig, tile_start=0,
                      n_tiles_local: int | None = None, light_volumes=None):
    """Render the flat tile range [tile_start, tile_start + n_tiles_local)
    (the shardable unit; the same contract as ``exact.render_tiles``).
    Returns ([n_tiles_local, tp, 4] tiles, stats)."""
    pairs = bin_particles(particles, camera, cfg, tile_start=tile_start,
                          n_tiles_local=n_tiles_local)
    C, T = _march_pairs_slab(pairs, particles, volumes, camera, light, cfg,
                             tile_start, light_volumes)
    tiles = composite_pairs(pairs, C, T, cfg, n_tiles_local=n_tiles_local)
    return tiles, pairs.stats


def render_slab(particles: Particles, volumes, camera: Camera, light: Light,
                cfg: SceneConfig, light_volumes=None):
    """Render one full frame with the slab engine.  Returns ([H, W, 4]
    fp32, stats)."""
    tiles, stats = render_slab_tiles(particles, volumes, camera, light, cfg,
                                     light_volumes=light_volumes)
    return assemble_image(tiles, cfg), stats
