"""volq_torch.core.trace: the program's spans and host-sync counters.

Off (no torch.profiler session), a frame opens no span and counts
nothing; under a profiler the ``volq.*`` spans of a c5-like frame (the
animated 4-D bank, the light and slab banks re-baked, the fused warp
render on a coarse interleaved canvas) nest as the module names them, the
counters key by the innermost span, ``core/device``'s ``h2d`` / ``d2h``
count off the CPU only, and the frames are bit-identical with and without
the profiler.  Imports neither JAX nor volq; the ``gpu`` case (each span's
counted host syncs equal to the trace's memcpy events under it, and to
the sync-debug warnings) runs on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_trace.py -q
"""
import contextlib
import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from volq_torch.core import trace
from volq_torch.core.device import d2h, h2d
from volq_torch.engine import loop
from volq_torch.scene.config import CameraConfig, VolumeConfig, c5

pytestmark = pytest.mark.filterwarnings("ignore:warp_pair=1 requested")

# each span's parent in a frame of an animated warp scene
PARENT = {
    "volq.frame": None,
    "volq.sim": "volq.frame",
    "volq.sim.emit": "volq.sim",
    "volq.sim.forces": "volq.sim",
    "volq.bake.volumes": "volq.frame",
    "volq.bake.light": "volq.frame",
    "volq.render": "volq.frame",
    "volq.bake.slabs": "volq.render",
    "volq.render.prep": "volq.render",
    "volq.render.march": "volq.render",
    "volq.render.composite": "volq.render",
    "volq.render.finish": "volq.render",
}


def _tiny_c5():
    c = c5()
    return dataclasses.replace(
        c, n_particles=16,
        volume=VolumeConfig(size=16, bank_size=4, octaves=1, animated=True,
                            noise_scale=5.0),
        emitter=dataclasses.replace(c.emitter, radius=1.6, size_min=0.5,
                                    size_max=0.9),
        camera=CameraConfig(eye=(0.0, 1.0, -5.5), look_at=(0.0, 0.2, 0.0),
                            fov_y_deg=45.0),
        render=dataclasses.replace(
            c.render, width=128, height=64, tile_w=32, steps=8,
            warp_rect=48, warp_march_rect=32, near_fade_start=0.0,
            near_fade_end=0.0))


def _frames(cfg, device, n, traced):
    """(state, image) after ``n`` frames from set-up; ``traced``: under a
    torch.profiler session, whose chrome trace is also returned."""
    state, camera, light = loop.setup(cfg, device)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.device(device).type == "cuda"
        else [])
    trace.reset()
    with profile(activities=acts) if traced else contextlib.nullcontext() \
            as prof:
        for _ in range(n):
            state, image, _ = loop.frames(state, camera, light, cfg, n=1)
    return state, image, prof


def _spans(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("volq.")]


def _parent(s, spans):
    """The shortest other span enclosing ``s``."""
    outer = [o for o in spans if o is not s and o[0] <= s[0]
             and s[1] <= o[1]]
    return min(outer, key=lambda o: o[1] - o[0])[2] if outer else None


def test_off_records_no_span_and_no_count(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name} opened with the profiler off")

    monkeypatch.setattr(trace.torch.profiler, "record_function", refuse)
    trace.reset()
    assert not trace.on()
    assert trace.span("volq.x") is trace.span("volq.y")
    with trace.span("volq.x"):
        trace.count("h2d")
    _frames(_tiny_c5(), "cpu", 1, traced=False)
    assert trace.counters() == {}
    assert trace._stack == []


def test_spans_nest_in_the_profiler_trace(tmp_path):
    _, _, prof = _frames(_tiny_c5(), "cpu", 1, traced=True)
    spans = _spans(prof, tmp_path)
    assert {s[2]: _parent(s, spans) for s in spans} == PARENT
    assert sorted(s[2] for s in spans) == sorted(PARENT)    # once each
    # on the CPU nothing crosses to a card: the frame alone is counted
    assert trace.counters() == {("volq.frame", "frames"): 1}
    assert trace._stack == []


def test_counters_key_by_the_innermost_span():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.on()
        trace.count("frames")
        with trace.span("volq.a"):
            trace.count("h2d")
            with trace.span("volq.a.b"):
                trace.count("h2d", 2)
                trace.count("d2h")
            trace.count("h2d")
    trace.count("h2d")                  # the profiler is off again
    want = {(None, "frames"): 1, ("volq.a", "h2d"): 2,
            ("volq.a.b", "h2d"): 2, ("volq.a.b", "d2h"): 1}
    assert trace.counters() == want
    assert trace.per_frame() == {"volq.a": {"h2d": 2.0},
                                 "volq.a.b": {"h2d": 2.0, "d2h": 1.0}}
    trace.reset()
    assert trace.counters() == {} and trace.per_frame() == {}


class _CardValue:
    """A stand-in for a 0-d tensor on a card."""
    device = torch.device("cuda")

    def item(self):
        return 7


def test_helpers_count_on_a_card_and_not_on_the_cpu():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("volq.t"):
            x = h2d([0.5, 2.0], torch.device("cpu"), torch.float32)
            m = h2d(1.5, torch.device("meta"), torch.float32)
            assert d2h(torch.tensor(3)) == 3
            assert d2h(_CardValue()) == 7
    assert torch.equal(x, torch.tensor([0.5, 2.0]))
    assert m.device.type == "meta" and m.dtype == torch.float32
    assert h2d(3, torch.device("cpu")).dtype == torch.int64
    assert trace.counters() == {("volq.t", "h2d"): 1, ("volq.t", "d2h"): 1}


def test_frames_bit_identical_with_the_profiler_on_and_off():
    cfg = _tiny_c5()
    off_state, off_image, _ = _frames(cfg, "cpu", 2, traced=False)
    on_state, on_image, _ = _frames(cfg, "cpu", 2, traced=True)
    assert torch.equal(off_image, on_image)
    for a, b in zip(off_state, on_state):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
        else:
            for x, y in zip(a, b):
                assert torch.equal(x, y)


@pytest.mark.gpu
def test_host_syncs_equal_the_trace_and_the_sync_warnings_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the counters count card copies)")
    from volq_torch.profile import sync_warnings, traced_frames
    cfg = _tiny_c5()
    state, camera, light = loop.setup(cfg)

    def step(st):
        return loop.frame(st, camera, light, cfg)[0]

    state = step(state)
    n = 2
    state, tab, counts, _ = traced_frames(step, state, n)
    counted = {}
    for (s, k), v in counts.items():
        if k in ("h2d", "d2h"):
            counted[s] = counted.get(s, 0) + v
    seen = {s: t["HtoD"] + t["DtoH"] for s, t in tab["spans"].items()
            if t["HtoD"] + t["DtoH"]}
    assert counted == seen
    assert set(counted) >= {"volq.sim", "volq.sim.forces",
                            "volq.bake.light", "volq.render.prep"}
    assert counts[("volq.frame", "frames")] == n
    _, hits, total = sync_warnings(step, state, n)
    assert hits == total == sum(counted.values())
