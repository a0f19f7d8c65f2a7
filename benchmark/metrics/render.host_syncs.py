"""render.host_syncs: blocking copies between host and card a frame in the
render: the program's h2d + d2h counters under volq.render and its parts
(prep, march, composite, finish; not the slab bake inside it), over the
frames of the profiled pass (benchmark/program_trace.py)."""
from benchmark.program_trace import host_syncs


def read(ctx):
    return host_syncs("render")
