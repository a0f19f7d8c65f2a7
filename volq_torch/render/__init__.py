"""The port's renderers.  ``render_frame`` dispatches on
``cfg.render.engine``: "warp" (``warp.py``: through the CUDA kernels on
the Pallas path, ``warp_xla.py``'s plain tensor code on the XLA path),
"slab" (``slab.py``) and "exact" (``exact.py``), both plain tensor code.
``render_frame_tiles`` renders a flat tile range of the two tile engines
(exact and slab), the unit the sharded frame splits over ranks."""
from volq_torch.core import trace
from volq_torch.render.binning import bin_particles, PairList
from volq_torch.render.exact import (render, render_tiles, composite_pairs,
                                     assemble_image)
from volq_torch.render.slab import render_slab, render_slab_tiles
from volq_torch.render.warp import render_warp


def render_frame(particles, volumes, camera, light, cfg, light_volumes=None,
                 slab_banks=None):
    """Engine-dispatching full-frame render (cfg.render.engine)."""
    with trace.span("volq.render"):
        if cfg.render.engine == "warp":
            return render_warp(particles, volumes, camera, light, cfg,
                               light_volumes=light_volumes,
                               slab_banks=slab_banks)
        if cfg.render.engine == "slab":
            return render_slab(particles, volumes, camera, light, cfg,
                               light_volumes=light_volumes)
        return render(particles, volumes, camera, light, cfg)


def render_frame_tiles(particles, volumes, camera, light, cfg, tile_start=0,
                       n_tiles_local=None, light_volumes=None):
    """Engine-dispatching tile-range render (the shardable unit)."""
    if cfg.render.engine == "slab":
        return render_slab_tiles(particles, volumes, camera, light, cfg,
                                 tile_start=tile_start,
                                 n_tiles_local=n_tiles_local,
                                 light_volumes=light_volumes)
    return render_tiles(particles, volumes, camera, light, cfg,
                        tile_start=tile_start, n_tiles_local=n_tiles_local)


__all__ = ["bin_particles", "PairList", "render", "render_tiles",
           "composite_pairs", "assemble_image", "render_slab",
           "render_slab_tiles", "render_warp", "render_frame",
           "render_frame_tiles"]
