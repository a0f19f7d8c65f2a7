"""render.ms: milliseconds a frame in the render (volq_torch/render/): the
synced span around ``render_frame`` less the slab bake inside it."""
from benchmark.tracing import self_seconds


def read(ctx):
    s = self_seconds(ctx["spans"], "render_frame")
    return s * 1e3 / ctx["frames"] if s > 0 else None
