"""render.idle_pct: share of the traced window in which the card sat idle
while the innermost span open was volq.render or one of its parts (not
the slab bake inside it), from the profiler's device timeline, in %
(benchmark/program_trace.py)."""
from benchmark.program_trace import idle_pct


def read(ctx):
    return idle_pct(ctx, "render")
