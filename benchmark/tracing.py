"""Spans around the program's layer entry points, and the reading of a
``torch.profiler`` trace.

``Hooks`` replaces each entry point, where the loop looks it up, by a
wrapper.  The wrapper always keeps the entry's last result (the comparison
reads the banks a frame baked); while spans are on it also opens a
``record_function`` span and synchronizes the card at both ends, so the
span's host-clock length is the layer's work.  With ``annotate`` on instead it
only opens the ``record_function`` span, for the profiler's idle gaps.  A
target that no longer exists raises, naming it.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict

# (module, attribute) of each layer entry point, as the frame loop finds it
TARGETS = (
    ("volq_torch.engine.loop", "sim_step"),
    ("volq_torch.engine.loop", "bake_volumes"),
    ("volq_torch.engine.loop", "render_light_volumes"),
    ("volq_torch.engine.loop", "render_frame"),
    ("volq_torch.render.warp", "bake_slab_banks"),
)


class Hooks:
    def __init__(self, sync):
        self.sync = sync            # the card's synchronize (None on CPU)
        self.on = False             # synced spans recorded
        self.annotate = False       # profiler annotations only, no sync
        self.spans = []             # (name, t0, t1, depth), host seconds
        self.last = {}              # name -> last result
        self._depth = 0
        self._saved = []

    def install(self):
        import importlib
        mods = [(importlib.import_module(m), a) for m, a in TARGETS]
        for (mod_name, attr), (mod, _) in zip(TARGETS, mods):
            if not hasattr(mod, attr):
                raise AttributeError(
                    f"layer entry point {mod_name}.{attr} is gone: the "
                    f"benchmark's span for it has nothing to wrap")
        for mod, attr in mods:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(attr, fn))

    def uninstall(self):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []
        self.last = {}

    def _wrap(self, name, fn):
        def wrapper(*a, **k):
            if not self.on:
                if self.annotate:
                    import torch
                    with torch.profiler.record_function(name):
                        out = fn(*a, **k)
                else:
                    out = fn(*a, **k)
                self.last[name] = out
                return out
            import torch
            with torch.profiler.record_function(name):
                if self.sync:
                    self.sync()
                t0 = time.perf_counter()
                self._depth += 1
                try:
                    out = fn(*a, **k)
                    if self.sync:
                        self.sync()
                finally:
                    self._depth -= 1
                self.spans.append((name, t0, time.perf_counter(),
                                   self._depth))
            self.last[name] = out
            return out
        wrapper.__wrapped__ = fn
        return wrapper


def span_seconds(spans, name):
    return sum(t1 - t0 for n, t0, t1, _ in spans if n == name)


def self_seconds(spans, name):
    """Total of ``name``'s spans less the spans nested directly in them."""
    total = 0.0
    for n, t0, t1, d in spans:
        if n != name:
            continue
        kids = sum(c1 - c0 for _, c0, c1, cd in spans
                   if cd == d + 1 and c0 >= t0 and c1 <= t1)
        total += (t1 - t0) - kids
    return total


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(path, window_name="frame"):
    """Summary of a chrome trace exported by torch.profiler, over the
    window from the first to the last ``window_name`` host span:
    busy_s (union of device activity), window_s, kernel_s by name, and
    idle gaps by the innermost host span open at each gap's middle."""
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    ann = [e for e in ev if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    frames = [e for e in ann if e["name"] == window_name]
    if not frames:
        return None
    w0 = min(e["ts"] for e in frames)
    w1 = max(e["ts"] + e["dur"] for e in frames)
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                 if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS
                 and e["ts"] + e["dur"] > w0 and e["ts"] < w1)
    kernel_s = defaultdict(float)
    for a, b, name in dev:
        kernel_s[name] += (b - a) * 1e-6
    busy, gaps, cur = 0.0, [], None
    for a, b, _ in dev:
        a, b = max(a, w0), min(b, w1)
        if cur is None:
            if a > w0:
                gaps.append((w0, a))
            cur = [a, b]
        elif a > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
        if cur[1] < w1:
            gaps.append((cur[1], w1))
    # sweep in time order with the stack of open host spans
    marks = []
    for i, e in enumerate(ann):
        marks.append((e["ts"], 0, i))
        marks.append((e["ts"] + e["dur"], 2, i))
    for a, b in gaps:
        marks.append((0.5 * (a + b), 1, b - a))
    marks.sort()
    idle, stack = defaultdict(float), []
    for _, kind, x in marks:
        if kind == 0:
            stack.append(x)
        elif kind == 2:
            stack.remove(x)
        else:
            idle[ann[stack[-1]]["name"] if stack else "outside"] += x * 1e-6
    return dict(busy_s=busy * 1e-6, window_s=(w1 - w0) * 1e-6,
                kernel_s=dict(kernel_s), idle_s=dict(idle))


def kernel_seconds(summary, *names):
    """Device seconds of the kernels whose name contains one of
    ``names``; None when none ran."""
    hits = [s for k, s in summary["kernel_s"].items()
            if any(n in k for n in names)]
    return sum(hits) if hits else None


def top(d, n=10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def short_names(d, width=96):
    """Kernel names cut at their argument list and to ``width`` letters,
    the seconds of names that then agree summed."""
    out = defaultdict(float)
    for k, v in d.items():
        out[k.split("(")[0][:width]] += v
    return dict(out)
