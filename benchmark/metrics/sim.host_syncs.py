"""sim.host_syncs: blocking copies between host and card a frame in the
sim step: the program's h2d + d2h counters under volq.sim and its parts
(volq.sim.emit, volq.sim.forces), over the frames of the profiled pass
(benchmark/program_trace.py)."""
from benchmark.program_trace import host_syncs


def read(ctx):
    return host_syncs("sim")
