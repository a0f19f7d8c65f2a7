"""The program's own spans and counters (``volq_torch/core/trace.py``) read
by layer, for the per-layer metrics of a traced run.

A layer is a ``volq.*`` span and its children: ``volq.sim`` (the sim
step), ``volq.bake`` (``volq.bake.volumes``, ``.light``, ``.slabs``: the
per-frame bakes) and ``volq.render`` (the render, less the slab bake a
render holds, whose ``volq.bake.slabs`` is the innermost span there).
The program counts and spans only while a torch.profiler session
records, which in a traced run is the harness's profiled pass alone.  A
program without those spans or counters gives None, never an error.
"""
from __future__ import annotations

LAYERS = {"sim": "volq.sim", "bake": "volq.bake", "render": "volq.render"}


def in_layer(span, layer: str) -> bool:
    root = LAYERS[layer]
    return span is not None and (span == root or span.startswith(root + "."))


def host_syncs(layer: str, counts=None):
    """Blocking copies between host and card a frame (the ``h2d`` and
    ``d2h`` counters) under ``layer``'s spans, over the frames that
    ``volq.frame`` counted; ``counts`` defaults to the program's."""
    if counts is None:
        try:
            from volq_torch.core import trace
        except ImportError:
            return None
        counts = trace.counters()
    frames = sum(v for (_, k), v in counts.items() if k == "frames")
    if not frames:
        return None
    return sum(v for (s, k), v in counts.items()
               if k in ("h2d", "d2h") and in_layer(s, layer)) / frames


def idle_pct(ctx, layer: str):
    """Share of the traced window, in %, in which the card sat idle while
    the innermost annotation open was one of ``layer``'s spans (the trace
    summary's ``idle_s``); None when the trace holds no program span."""
    s = ctx["summary"]
    if not s or s["window_s"] <= 0:
        return None
    idle = s["idle_s"]
    if not any(k.startswith("volq.") for k in idle):
        return None
    return 100.0 * sum(v for k, v in idle.items()
                       if in_layer(k, layer)) / s["window_s"]
