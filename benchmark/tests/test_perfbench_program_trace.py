"""The per-layer metrics read from the program's own spans and counters
(benchmark/program_trace.py and its six readers), on a hand-made trace
and hand-made counters, and silent on a program that has neither."""
import json

import pytest

from benchmark import program_trace, spec, tracing

ANN = "user_annotation"


def _x(name, ts, dur, cat=ANN):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def _summary(tmp_path, ev):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return tracing.read_trace(p)


def test_idle_goes_to_the_innermost_program_span(tmp_path):
    # one 100-us frame: the harness's annotations around the program's
    # spans; the render holds the slab bake
    ev = [_x("frame", 0, 100), _x("volq.frame", 1, 98),
          _x("sim_step", 1, 30), _x("volq.sim", 2, 28),
          _x("volq.sim.forces", 15, 10),
          _x("bake_volumes", 31, 19), _x("volq.bake.volumes", 32, 17),
          _x("render_frame", 50, 50), _x("volq.render", 51, 48),
          _x("bake_slab_banks", 52, 10), _x("volq.bake.slabs", 53, 8),
          _x("volq.render.march", 70, 20),
          _x("k_sim", 0, 6, "kernel"), _x("k_bake", 32, 6, "kernel"),
          _x("Memcpy HtoD", 56, 2, "gpu_memcpy"),
          _x("k_march", 71, 10, "kernel"), _x("k_end", 97, 2.5, "kernel")]
    s = _summary(tmp_path, ev)
    # gaps by their middles: 6-32 (19), 38-56 (47), 58-71 (64.5), 81-97
    # (89), and 99.5-100 after the program's spans closed
    assert s["idle_s"] == pytest.approx({
        "volq.sim.forces": 26e-6, "volq.bake.volumes": 18e-6,
        "volq.render": 13e-6, "volq.render.march": 16e-6,
        "render_frame": 0.5e-6})
    ctx = dict(summary=s)
    got = {m: spec.metric_reader(m)(ctx) for m in
           ("sim.idle_pct", "bake.idle_pct", "render.idle_pct")}
    assert got == pytest.approx({"sim.idle_pct": 26.0, "bake.idle_pct": 18.0,
                                 "render.idle_pct": 29.0})
    device = spec.metric_reader("device.idle_pct")(ctx)
    assert device == pytest.approx(73.5)
    assert sum(got.values()) == pytest.approx(device - 0.5)


def test_idle_is_silent_without_program_spans(tmp_path):
    ev = [_x("frame", 0, 100), _x("sim_step", 0, 60),
          _x("k", 10, 10, "kernel")]
    ctx = dict(summary=_summary(tmp_path, ev))
    for m in ("sim.idle_pct", "bake.idle_pct", "render.idle_pct"):
        assert spec.metric_reader(m)(ctx) is None
    assert program_trace.idle_pct(dict(summary=None), "sim") is None


COUNTS = {("volq.frame", "frames"): 4, ("volq.sim", "h2d"): 8,
          ("volq.sim.emit", "h2d"): 36, ("volq.sim.forces", "h2d"): 40,
          ("volq.bake.volumes", "h2d"): 12, ("volq.bake.light", "d2h"): 12,
          ("volq.bake.slabs", "h2d"): 16, ("volq.render", "h2d"): 0,
          ("volq.render.prep", "h2d"): 32, ("volq.render.finish", "h2d"): 4,
          ("volq.simulated", "h2d"): 100, (None, "h2d"): 7,
          ("volq.render.march", "launches"): 4}


@pytest.mark.parametrize("layer,want", [("sim", 21.0), ("bake", 10.0),
                                        ("render", 9.0)])
def test_host_syncs_a_frame_by_layer(layer, want):
    assert program_trace.host_syncs(layer, COUNTS) == want


def test_host_syncs_read_the_program_counters(monkeypatch):
    from volq_torch.core import trace
    monkeypatch.setattr(trace, "_counts", dict(COUNTS))
    got = {m: spec.metric_reader(m)({}) for m in
           ("sim.host_syncs", "bake.host_syncs", "render.host_syncs")}
    assert got == {"sim.host_syncs": 21.0, "bake.host_syncs": 10.0,
                   "render.host_syncs": 9.0}
    monkeypatch.setattr(trace, "_counts", {})
    assert spec.metric_reader("sim.host_syncs")({}) is None


def test_host_syncs_silent_without_the_program_module(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "volq_torch.core.trace", None)
    assert program_trace.host_syncs("sim") is None
