"""The reading of a profiler trace and of the synced spans, by hand."""
import json

import pytest

from benchmark import tracing


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_read_trace(tmp_path):
    ann = "user_annotation"
    ev = [_x("frame", 0, 100, ann), _x("frame", 100, 100, ann),
          _x("sim_step", 0, 60, ann), _x("sim_step", 100, 60, ann),
          _x("render_frame", 60, 40, ann), _x("render_frame", 160, 40, ann),
          _x("warp_march_kernel<1>", 10, 10, "kernel"),
          _x("add", 15, 15, "kernel"), _x("warp_march_kernel<1>", 70, 20,
                                           "kernel"),
          _x("Memcpy HtoD", 110, 5, "gpu_memcpy"),
          _x("tile_fill_kernel", 170, 10, "kernel"),
          _x("aten::add", 20, 5, "cpu_op")]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    s = tracing.read_trace(p)
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(55e-6)
    assert s["idle_s"] == pytest.approx({"sim_step": 125e-6,
                                         "render_frame": 20e-6})
    assert tracing.kernel_seconds(s, "warp_march_kernel") == \
        pytest.approx(30e-6)
    assert tracing.kernel_seconds(s, "no_such") is None
    assert tracing.top({"a": 1.0, "b": 3.0}, 1) == [["b", 3.0]]


def test_span_self_time():
    spans = [("frame", 0.0, 10.0, 0), ("sim_step", 0.0, 4.0, 1),
             ("render_frame", 4.0, 10.0, 1), ("bake_slab_banks", 5.0, 6.5, 2)]
    assert tracing.span_seconds(spans, "sim_step") == 4.0
    assert tracing.self_seconds(spans, "render_frame") == pytest.approx(4.5)


def test_hooks_wrap_and_name_what_is_gone(monkeypatch):
    from volq_torch.engine import loop
    h = tracing.Hooks(None)
    h.install()
    try:
        assert loop.sim_step.__wrapped__ is not None
    finally:
        h.uninstall()
    assert not hasattr(loop.sim_step, "__wrapped__")
    monkeypatch.delattr(loop, "render_frame")
    with pytest.raises(AttributeError, match="render_frame"):
        tracing.Hooks(None).install()
    assert not hasattr(loop.sim_step, "__wrapped__")   # nothing half-done
