"""Spans and counters at the layer boundaries of the frame.

They are on exactly while a ``torch.profiler`` session records, and off
otherwise: there is no flag.  Off, ``span`` returns one shared no-op
context and ``count`` returns at once, after one attribute check each.

On, ``span(name)`` opens ``torch.profiler.record_function(name)``, so the
span lies in the profiler's own timeline, on the clock of the card's
kernels, copies and idle gaps; parents are given by nesting.  It also
pushes ``name`` on a stack, and ``count(name, n)`` adds ``n`` to the
counter keyed by (innermost open span, ``name``), or (None, ``name``)
outside every span.  ``counters()`` reads the counters and ``reset()``
clears them.  Spans are named ``volq.<layer>[.<part>]``:

    volq.frame              engine/loop._frame_body (counts ``frames``)
    volq.sim                sim/step.sim_step
      volq.sim.emit           emission and spawn_attrs (on a card the
                              sim_scan and sim_spawn launches)
      volq.sim.forces         sim/forces.total_force (on a card the
                              sim_forces launch)
    volq.bake.volumes       scene/state.bake_volumes
    volq.bake.light         volume/lightbake.render_light_volumes
    volq.bake.slabs         render/warp.bake_slab_banks
    volq.render             render.render_frame
      volq.render.prep        the kernels' inputs (geometry, depth order)
      volq.render.march       kernel A or C (the exact engine's march)
      volq.render.composite   the canvas's init and kernel B or D
      volq.render.finish      the canvas over the background

The counters ``h2d`` and ``d2h`` count the blocking copies between host
and card (``core/device.h2d`` and ``d2h``); ``const_miss`` and
``const_hit`` count the configuration constants ``core/device.const``
made (one ``h2d`` each) and served from its cache (no copy).  Every
kernel launch counts
under its C function's name (``_build.launch``: ``sim_scan_launch``,
``sim_spawn_launch``, ``sim_forces_launch``, ``noise_bake_launch``,
``light_bake_launch``, ``warp_march_launch``, ``warp_composite_launch``,
...); ``sim_torch``, ``noise_torch`` and ``light_torch`` count the calls
of the sim step's, the noise bank's and the light bank's plain versions
(``sim/step.py``, ``volume/bake.py``, ``volume/lightbake.py``), so a
frame shows which path each took.
"""
from __future__ import annotations

import contextlib
from collections import Counter

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_stack: list[str] = []
_counts: Counter = Counter()


def on() -> bool:
    """True while a torch.profiler session records."""
    return _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = torch.profiler.record_function(name)

    def __enter__(self):
        self._rf.__enter__()
        _stack.append(self.name)
        return self

    def __exit__(self, *exc):
        _stack.pop()
        return self._rf.__exit__(*exc)


def span(name: str):
    """A context recording the span ``name`` while the profiler is on."""
    return _Span(name) if on() else _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``name`` under the innermost open span, while the
    profiler is on."""
    if on():
        _counts[_stack[-1] if _stack else None, name] += n


def counters() -> dict:
    """{(span or None, counter name): total} since the last ``reset``."""
    return dict(_counts)


def reset() -> None:
    _counts.clear()


def per_frame(counts: dict | None = None) -> dict:
    """{span: {counter: total / frames}} of ``counts`` (default:
    ``counters()``), over the ``frames`` that ``volq.frame`` counted;
    empty when it counted none."""
    counts = counters() if counts is None else counts
    frames = sum(v for (_, k), v in counts.items() if k == "frames")
    out: dict = {}
    if not frames:
        return out
    for (s, k), v in sorted(counts.items(), key=lambda kv: str(kv[0])):
        if k != "frames":
            out.setdefault(s, {})[k] = v / frames
    return out
