"""sim.ms: milliseconds a frame in the sim step (volq_torch/sim/), the
synced span around ``sim_step`` as the frame loop calls it."""
from benchmark.tracing import span_seconds


def read(ctx):
    s = span_seconds(ctx["spans"], "sim_step")
    return s * 1e3 / ctx["frames"] if s > 0 else None
