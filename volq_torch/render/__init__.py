"""The port's renderers.  ``render_frame`` dispatches on
``cfg.render.engine``: "warp" (``warp.py``: through the CUDA kernels on
the Pallas path, ``warp_xla.py``'s plain tensor code on the XLA path) and
"exact" (``exact.py``, plain tensor code) are ported; "slab" raises
(``warp.check_supported`` names its ROADMAP item)."""
from volq_torch.render.binning import bin_particles, PairList
from volq_torch.render.exact import (render, render_tiles, composite_pairs,
                                     assemble_image)
from volq_torch.render.warp import render_warp, check_supported


def render_frame(particles, volumes, camera, light, cfg, light_volumes=None,
                 slab_banks=None):
    """Engine-dispatching full-frame render (cfg.render.engine)."""
    check_supported(cfg)
    if cfg.render.engine == "warp":
        return render_warp(particles, volumes, camera, light, cfg,
                           light_volumes=light_volumes,
                           slab_banks=slab_banks)
    return render(particles, volumes, camera, light, cfg)


__all__ = ["bin_particles", "PairList", "render", "render_tiles",
           "composite_pairs", "assemble_image", "render_frame",
           "render_warp", "check_supported"]
