"""volq_torch.core.trace: the program's spans and host-sync counters.

Off (no torch.profiler session), a frame opens no span and counts
nothing; under a profiler the ``volq.*`` spans of a c5-like frame (the
animated 4-D bank, the light and slab banks re-baked, the fused warp
render on a coarse interleaved canvas) nest as the module names them, the
counters key by the innermost span, ``core/device``'s ``h2d`` / ``d2h``
count off the CPU only, ``const`` serves a configuration constant from
its cache after one counted copy (and raises once it was written in
place), and the frames are bit-identical with and without the profiler
and with the constants' cache warm or cleared.  Imports neither JAX nor volq; the ``gpu`` case (each span's
counted host syncs equal to the trace's memcpy events under it, and to
the sync-debug warnings; a frame's bank baked by the noise kernel, once,
and its light bank swept by the light kernel, once, with no copy) runs
on the card, as does the ``gpu`` case of the sim (a card frame's
step made by the sim's kernels: ``sim_scan_launch`` and
``sim_spawn_launch`` under ``volq.sim.emit``, ``sim_forces_launch`` under
``volq.sim.forces``, no ``sim_torch`` and no copy under ``volq.sim*``;
the reverse on the CPU), and the ``gpu`` case of the warm frame (three
frames of a c5-like scene under sync-debug mode "error", with the
recorded launches and no copy):

    python -m pytest --noconftest -m gpu tests/test_torch_trace.py -q
"""
import contextlib
import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from volq_torch.core import device, trace
from volq_torch.core.device import const, d2h, h2d
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
    # on the CPU nothing crosses to a card: the frame, the plain sim step,
    # the volume bank's plain bake and the plain light sweep alone are
    # counted
    assert trace.counters() == {("volq.frame", "frames"): 1,
                                ("volq.sim", "sim_torch"): 1,
                                ("volq.bake.volumes", "noise_torch"): 1,
                                ("volq.bake.light", "light_torch"): 1}
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
    # a cleared cache: the first traced frame copies its configuration
    # constants again, the second makes no copy
    device.clear_consts()
    state, tab, counts, _ = traced_frames(step, state, n)
    counted = {}
    for (s, k), v in counts.items():
        if k in ("h2d", "d2h"):
            counted[s] = counted.get(s, 0) + v
    seen = {s: t["HtoD"] + t["DtoH"] for s, t in tab["spans"].items()
            if t["HtoD"] + t["DtoH"]}
    assert counted == seen
    # the copies are the constants' first copies (prep, slab bake and
    # finish); the sim's and the light sweep's kernels read their inputs
    # on the card: no copy
    misses = sum(v for (_, k), v in counts.items() if k == "const_miss")
    assert sum(counted.values()) == misses > 0
    assert {"volq.render.prep", "volq.bake.slabs",
            "volq.render.finish"} == set(counted)
    assert counts[("volq.frame", "frames")] == n
    device.clear_consts()
    _, hits, total = sync_warnings(step, state, n)
    assert hits == total == misses


@pytest.mark.gpu
def test_a_card_frame_bakes_its_bank_with_the_noise_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the noise kernel has no CPU mode)")
    cfg = _tiny_c5()
    state, camera, light = loop.setup(cfg)
    state = loop.frame(state, camera, light, cfg)[0]
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        state = loop.frame(state, camera, light, cfg)[0]
    assert trace.per_frame()["volq.bake.volumes"] == \
        {"noise_bake_launch": 1.0}
    assert not any(k == "noise_torch" for _, k in trace.counters())


@pytest.mark.gpu
def test_a_card_frame_sweeps_its_light_bank_with_the_light_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the light kernel has no CPU mode)")
    cfg = _tiny_c5()
    state, camera, light = loop.setup(cfg)
    state = loop.frame(state, camera, light, cfg)[0]
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        loop.frame(state, camera, light, cfg)
    assert trace.per_frame()["volq.bake.light"] == \
        {"light_bake_launch": 1.0}
    assert not any(k == "light_torch" for _, k in trace.counters())
    trace.reset()


def _sim_counts():
    """{(span, counter): total} under the ``volq.sim*`` spans."""
    return {(s, k): v for (s, k), v in trace.counters().items()
            if s and s.startswith("volq.sim")}


def test_a_cpu_frame_steps_the_sim_by_its_plain_version():
    cfg = _tiny_c5()
    state, camera, light = loop.setup(cfg, "cpu")
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        loop.frame(state, camera, light, cfg)
    assert _sim_counts() == {("volq.sim", "sim_torch"): 1}
    trace.reset()


@pytest.mark.gpu
def test_a_card_frame_steps_the_sim_with_its_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sim's kernels have no CPU "
                    "mode)")
    cfg = _tiny_c5()
    state, camera, light = loop.setup(cfg)
    state = loop.frame(state, camera, light, cfg)[0]
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        loop.frame(state, camera, light, cfg)
    assert _sim_counts() == {("volq.sim.emit", "sim_scan_launch"): 1,
                             ("volq.sim.emit", "sim_spawn_launch"): 1,
                             ("volq.sim.forces", "sim_forces_launch"): 1}
    trace.reset()


@pytest.fixture
def consts():
    """The constants' cache, cleared before and after the test."""
    device.clear_consts()
    yield device._consts
    device.clear_consts()


def test_const_is_made_once_per_value_dtype_and_device(consts):
    a = const([0.25, -1.5], "cpu", torch.float32)
    assert const([0.25, -1.5], "cpu", torch.float32) is a
    assert torch.equal(a, torch.tensor([0.25, -1.5]))
    others = [const([0.25, -1.5], "cpu", torch.float64),
              const([0.25, -1.5], "meta", torch.float32),
              const([0.25, -1.0], "cpu", torch.float32),
              const(0.0, "cpu", torch.float32),
              const(-0.0, "cpu", torch.float32)]
    assert len({id(t) for t in [a] + others}) == 6 == len(consts)
    assert others[0].dtype == torch.float64
    assert others[1].device.type == "meta"
    assert torch.signbit(others[4]) and not torch.signbit(others[3])
    z = const([3, 4], "cpu", torch.int64)
    assert z.dtype == torch.int64 and const((3, 4), "cpu", torch.int64) is z


def test_const_counts_its_miss_once_and_copies_only_then(consts):
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("volq.t"):
            m = const([1.0, 2.0, 4.0], torch.device("meta"), torch.float32)
            for _ in range(3):
                assert const([1.0, 2.0, 4.0], "meta", torch.float32) is m
            const(7, "meta", torch.int64)
            const([1.0, 2.0, 4.0], "cpu", torch.float32)     # not counted
            const([1.0, 2.0, 4.0], "cpu", torch.float32)
    assert trace.counters() == {("volq.t", "const_miss"): 2,
                                ("volq.t", "h2d"): 2,
                                ("volq.t", "const_hit"): 3}
    trace.reset()


def test_const_written_in_place_raises_at_the_next_hit(consts):
    t = const([0.5, 1.5], "cpu", torch.float32)
    t[None][:, 1].mul_(2.0)         # a write through a view counts too
    with pytest.raises(RuntimeError, match="written in place"):
        const([0.5, 1.5], "cpu", torch.float32)
    # out-of-place reads, as the callers make, leave it usable
    u = const([2.0], "cpu", torch.float32)
    _ = (u + 1, u[None, :], u * u)
    assert const([2.0], "cpu", torch.float32) is u


def test_frames_bit_identical_with_the_const_cache_warm_and_cleared(consts):
    """Two frames of one state of a tiny lit, coarse, interleaved,
    animated scene (every bank re-baked) with the constants served from
    the cache, and one after clearing it: the same bits; the second
    frame makes no new constant."""
    cfg = _tiny_c5()
    r = cfg.render
    assert r.light_steps > 0 and r.warp_coarse and r.warp_interleave
    assert cfg.volume.animated
    state, camera, light = loop.setup(cfg, "cpu")

    def frame():
        return loop.frame(state, camera, light, cfg)

    device.clear_consts()
    st0, im0, _ = frame()
    made = dict(consts)
    assert made
    st1, im1, _ = frame()
    st2, im2, _ = frame()
    assert dict(consts) == made
    device.clear_consts()
    st3, im3, _ = frame()
    for st, im in ((st1, im1), (st2, im2), (st3, im3)):
        assert torch.equal(im0, im)
        assert torch.equal(st0.volumes, st.volumes)
        for a, b in zip(st0.particles, st.particles):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_warm_card_frames_make_no_sync_and_the_recorded_launches():
    """After one warm frame, three frames of a c5-like animated scene
    under sync-debug mode "error": no synchronizing operation, and per
    frame A 1, B 1, the noise kernel 1, the light kernel 1 and the sim's
    three launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the frame's kernels run there)")
    from volq_torch import _build
    cfg = _tiny_c5()
    state, camera, light = loop.setup(cfg)
    state = loop.frame(state, camera, light, cfg)[0]
    torch.cuda.synchronize()
    _build.launches.clear()
    n = 3
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            state = loop.frame(state, camera, light, cfg)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    want = ("warp_march_launch", "warp_composite_launch",
            "noise_bake_launch", "light_bake_launch", "sim_scan_launch",
            "sim_spawn_launch", "sim_forces_launch")
    assert dict(_build.launches) == {name: n for name in want}
