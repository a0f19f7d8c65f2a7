"""bake.idle_pct: share of the traced window in which the card sat idle
while the innermost span open was volq.bake.volumes, volq.bake.light or
volq.bake.slabs, from the profiler's device timeline, in %
(benchmark/program_trace.py)."""
from benchmark.program_trace import idle_pct


def read(ctx):
    return idle_pct(ctx, "bake")
