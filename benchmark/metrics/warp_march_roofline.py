"""warp_march_roofline: kernel A's least time on the traced frames (from
the configuration and the reference's geometry, benchmark/roofline.py)
over its device time summed by name in the trace, in %."""
from benchmark.tracing import kernel_seconds


def read(ctx):
    dev = kernel_seconds(ctx["summary"], "warp_march_kernel")
    if not dev or not ctx["bounds"]:
        return None
    return 100.0 * sum(b["warp_march"] for b in ctx["bounds"]) / dev
