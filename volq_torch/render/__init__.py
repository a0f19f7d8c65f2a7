from volq_torch.render.warp import render_warp, check_supported


def render_frame(particles, volumes, camera, light, cfg, light_volumes=None,
                 slab_banks=None):
    """Engine-dispatching full-frame render (cfg.render.engine); only the
    warp engine is ported."""
    if cfg.render.engine == "warp":
        return render_warp(particles, volumes, camera, light, cfg,
                           light_volumes=light_volumes,
                           slab_banks=slab_banks)
    raise NotImplementedError(
        f"volq_torch does not port the {cfg.render.engine!r} engine yet "
        "(ROADMAP Queue 1 items 10-11)")


__all__ = ["render_frame", "render_warp", "check_supported"]
