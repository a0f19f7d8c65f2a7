"""The exact engine: the per-ray gather raymarch (counterpart of
``volq/render/xla_render.py``, the JAX package's plain-XLA renderer; the
engine ``render.engine == "exact"`` selects, preset c1's).  Plain tensor
code, no kernel.

Per frame:

  1. bin alive particles into depth-ordered (tile, particle) pairs
     (``render/binning.py``);
  2. march every kept pair: tile rays against the particle's AABB,
     ``steps`` midpoint samples of its density volume (trilinear gathers,
     ``core/interp.py``), an optional secondary light march, front-to-back
     accumulation within the pair -> premultiplied colour and
     transmittance per pixel;
  3. composite the pairs of each tile in depth order with the associative
     OVER operator, then stitch the tiles into the [H, W, 4] frame.

The semantics are the oracle's; a frame matches it within 1e-3 per pixel.
All shapes are fixed by the config and there is no data-dependent control
flow: misses are predicated to zero alpha, as in the oracle's masked math.
"""
from __future__ import annotations

import torch

from volq_torch.core import trace
from volq_torch.core.aabb import ray_aabb
from volq_torch.core.camera import pixel_rays, view_z
from volq_torch.core.device import scalar
from volq_torch.core.interp import sample_bank_trilinear
from volq_torch.core.types import Camera, Light, Particles
from volq_torch.render.binning import bin_particles, PairList
from volq_torch.render.common import _fade, _near_fade
from volq_torch.scene.config import SceneConfig


def _march_pairs(pairs: PairList, particles: Particles, bank2d,
                 vol_size: int, camera: Camera, light: Light,
                 cfg: SceneConfig, tile_start=0):
    """March all kept pairs.  Returns (C [P, tp, 3], t [P, tp]), the
    premultiplied colour and transmittance of each pair, fp32."""
    r = cfg.render
    tiles_x = r.width // r.tile_w
    tp = r.tile_h * r.tile_w
    V = vol_size
    dev = bank2d.device
    gtile = pairs.tile + torch.as_tensor(tile_start, dtype=torch.int32,
                                         device=dev)

    pid = pairs.pid.long()
    pos = particles.pos[pid]                       # [P,3]
    half = particles.size[pid][:, None]            # [P,1]
    albedo = particles.albedo[pid]                 # [P,3]
    vol = particles.vol_idx[pid]                   # [P] bank row
    tau_life = particles.age[pid] / torch.clamp(particles.lifetime[pid],
                                                min=1e-6)
    scale = (r.density_scale * _fade(tau_life, r.fade_in, r.fade_out)
             * _near_fade(view_z(camera, pos), r))[:, None]  # [P,1]

    # tile pixel rays [P, tp]; invalid / padded pairs clamp into range
    ti = torch.arange(tp, dtype=torch.int32, device=dev)
    px = (gtile % tiles_x)[:, None] * r.tile_w + (ti % r.tile_w)[None, :]
    ty = torch.clamp(torch.div(gtile, tiles_x, rounding_mode="floor"),
                     max=r.height // r.tile_h - 1)
    py = ty[:, None] * r.tile_h \
        + torch.div(ti, r.tile_w, rounding_mode="floor")[None, :]
    o, d = pixel_rays(camera, px, py, r.width, r.height,
                      cfg.camera.projection)        # [P,tp,3]

    lo = pos[:, None, :] - half[..., None]          # [P,1,3]
    hi = pos[:, None, :] + half[..., None]
    t0, t1 = ray_aabb(o, d, lo, hi)                 # [P,tp]
    seg = t1 - t0
    covered = (seg > 0) & pairs.valid[:, None]
    zeros = torch.zeros_like(seg)
    dt = torch.where(covered, seg / scalar(r.steps, seg), zeros)

    l_dir = light.direction
    box = 2.0 * half[..., None]

    def density_at(p):
        """p: [P, tp, 3] world -> sigma [P, tp] (fade and scale applied)."""
        u = (p - lo) / box
        return sample_bank_trilinear(bank2d, V, vol[:, None], u) * scale

    def light_atten(p):
        _, lt1 = ray_aabb(p, l_dir.expand(p.shape), lo, hi)
        dl = torch.clamp(lt1, min=0.0) / scalar(r.light_steps, lt1)
        tau = torch.zeros_like(dl)
        for j in range(r.light_steps):
            lp = p + ((j + 0.5) * dl)[..., None] * l_dir
            tau = tau + density_at(lp) * dl
        return torch.exp(-tau)

    unlit = light.color + light.ambient
    P = pid.shape[0]
    C = torch.zeros((P, tp, 3), dtype=torch.float32, device=dev)
    T = torch.ones((P, tp), dtype=torch.float32, device=dev)
    for s in range(r.steps):
        t = t0 + (s + 0.5) * dt
        p = o + t[..., None] * d
        sigma = density_at(p)
        alpha = torch.where(covered, 1.0 - torch.exp(-sigma * dt), zeros)
        lit = (light.color * light_atten(p)[..., None] + light.ambient
               if r.light_steps > 0 else unlit)
        c = albedo[:, None, :] * lit
        C = C + (T * alpha)[..., None] * c
        T = T * (1.0 - alpha)
    return C, T


def composite_pairs(pairs: PairList, C_pair, t_pair, cfg: SceneConfig,
                    n_tiles_local: int | None = None, row_map=None):
    """Depth-ordered per-tile OVER compositing of marched pairs.
    ``row_map`` (optional, [P_kept] integer) redirects pair q to a row of
    the marched buffers, for a march laid out per particle
    (``pairs.sort_idx``).  Returns flat tiles [n_tiles_local, tp, 4] fp32
    (see ``assemble_image``)."""
    r = cfg.render
    tiles_x = r.width // r.tile_w
    tiles_y = r.height // r.tile_h
    n_tiles = n_tiles_local if n_tiles_local is not None \
        else tiles_x * tiles_y
    tp = r.tile_h * r.tile_w
    P = pairs.pid.shape[0]
    dev = C_pair.device

    C = torch.zeros((n_tiles, tp, 3), dtype=torch.float32, device=dev)
    T = torch.ones((n_tiles, tp), dtype=torch.float32, device=dev)
    for k in range(min(r.max_pairs_per_tile, P)):
        q = torch.clamp(pairs.seg_start + k, max=P - 1).long()
        use = (k < pairs.count) & pairs.valid[q]
        row = row_map[q].long() if row_map is not None else q
        Ck = torch.where(use[:, None, None], C_pair[row],
                         torch.zeros((), dtype=torch.float32, device=dev))
        tk = torch.where(use[:, None], t_pair[row],
                         torch.ones((), dtype=torch.float32, device=dev))
        C = C + T[..., None] * Ck
        T = T * tk

    bg = torch.tensor(r.background, dtype=torch.float32, device=dev)
    return torch.cat([C + T[..., None] * bg, (1.0 - T)[..., None]], dim=-1)


def assemble_image(flat_tiles, cfg: SceneConfig):
    """[n_tiles, tp, 4] flat tiles -> [H, W, 4] frame."""
    r = cfg.render
    tiles_x = r.width // r.tile_w
    tiles_y = r.height // r.tile_h
    img = flat_tiles[:tiles_x * tiles_y].reshape(
        tiles_y, tiles_x, r.tile_h, r.tile_w, 4)
    return img.permute(0, 2, 1, 3, 4).reshape(r.height, r.width, 4)


def render_tiles(particles: Particles, volumes, camera: Camera,
                 light: Light, cfg: SceneConfig, tile_start=0,
                 n_tiles_local: int | None = None):
    """Render a flat range of screen tiles (the shardable unit).
    Returns ([n_tiles_local, tp, 4] tiles, stats)."""
    V = volumes.shape[-1]
    bank2d = volumes.reshape(volumes.shape[0], -1)
    with trace.span("volq.render.prep"):
        pairs = bin_particles(particles, camera, cfg, tile_start=tile_start,
                              n_tiles_local=n_tiles_local)
    with trace.span("volq.render.march"):
        C_pair, t_pair = _march_pairs(pairs, particles, bank2d, V, camera,
                                      light, cfg, tile_start=tile_start)
    with trace.span("volq.render.composite"):
        tiles = composite_pairs(pairs, C_pair, t_pair, cfg,
                                n_tiles_local=n_tiles_local)
    return tiles, pairs.stats


def render(particles: Particles, volumes, camera: Camera, light: Light,
           cfg: SceneConfig):
    """Render one full frame on one device.  Returns ([H, W, 4] fp32,
    stats)."""
    tiles, stats = render_tiles(particles, volumes, camera, light, cfg)
    with trace.span("volq.render.finish"):
        return assemble_image(tiles, cfg), stats
