"""bake.ms: milliseconds a frame in the per-frame bakes of an animated
scene: the synced spans around the 4-D volume bake (``bake_volumes``), the
light bake (``render_light_volumes``) and the slab bake
(``bake_slab_banks``)."""
from benchmark.tracing import span_seconds

_BAKES = ("bake_volumes", "render_light_volumes", "bake_slab_banks")


def read(ctx):
    if not any(n == "bake_volumes" for n, *_ in ctx["spans"]):
        return None
    s = sum(span_seconds(ctx["spans"], b) for b in _BAKES)
    return s * 1e3 / ctx["frames"]
