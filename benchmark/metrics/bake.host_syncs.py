"""bake.host_syncs: blocking copies between host and card a frame in the
per-frame bakes: the program's h2d + d2h counters under
volq.bake.volumes, volq.bake.light and volq.bake.slabs, over the frames
of the profiled pass (benchmark/program_trace.py)."""
from benchmark.program_trace import host_syncs


def read(ctx):
    return host_syncs("bake")
