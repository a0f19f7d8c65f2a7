"""warp_composite_roofline: kernel B's least time on the traced frames
(benchmark/roofline.py) over the device time of its launch, the composite
kernel and the tile-list fill kernel it starts, in %."""
from benchmark.tracing import kernel_seconds


def read(ctx):
    dev = kernel_seconds(ctx["summary"], "warp_composite_kernel",
                         "tile_fill_kernel")
    if not dev or not ctx["bounds"]:
        return None
    return 100.0 * sum(b["warp_composite"] for b in ctx["bounds"]) / dev
