"""One run of a cell: set-up, warm-up to a steady pace, the measured (or
traced) window over ``volq_torch.engine.loop.frames``, and the comparison
of what the window produced with the plain reference.

Every line before the result is a record of the run: warm-up slices, the
window in 5-second slices, stalls, garbage-collector passes, host CPU
clock, the card's SM clock.  Nothing here is particular to a cell.
"""
from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

from . import compare, reference, spec, tracing
from .reference import warp as ref_warp
from .roofline import frame_bounds

TRACE_SECONDS = 3.0     # length of a traced window (at most --seconds)
WARM_SLICE_S = 1.0      # warm-up slice
WARM_AGREE = 0.05       # two slices agree within this share
WARM_SLICES = 5         # at most this many warm-up slices
NOISE_SLICE_S = 5.0     # the window's slices, as printed
STALL = 2.0             # a stall: a frame over this many median frames


def say(*a):
    print(*a, flush=True)


class GcWatch:
    """Garbage-collector passes while ``on``, timed by ``gc.callbacks``
    (which only observes them)."""

    def __init__(self):
        self.on = False
        self.passes = [0, 0, 0]
        self.ms = 0.0
        self._t = None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if not self.on:
            return
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.ms += (time.perf_counter() - self._t) * 1e3
            self.passes[info["generation"]] += 1
            self._t = None

    def close(self):
        gc.callbacks.remove(self._cb)


def cpu_mhz():
    """Mean 'cpu MHz' of the CPUs this process may run on (None where
    /proc/cpuinfo does not say)."""
    mine = os.sched_getaffinity(0)
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return None
    vals, cpu = [], None
    for line in text.splitlines():
        k, _, v = line.partition(":")
        if k.strip() == "processor":
            cpu = int(v)
        elif k.strip() == "cpu MHz" and cpu in mine:
            vals.append(float(v))
    return statistics.fmean(vals) if vals else None


def host_sample():
    """(host seconds, this process's CPU seconds, involuntary context
    switches, the machine's steal jiffies, all its jiffies)."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        with open("/proc/stat") as f:
            j = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        j = [0]
    return (time.perf_counter(), ru.ru_utime + ru.ru_stime, ru.ru_nivcsw,
            j[7] if len(j) > 7 else 0, sum(j[:8]))


def _smi(*query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={','.join(query)}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.splitlines()[0]


class SmiSampler:
    """nvidia-smi sampling the SM clock, power and temperature every 5 s
    beside the run; started before the warm-up so that its start-up is
    done by the window."""

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,"
             "temperature.gpu", "--format=csv,noheader,nounits",
             "-lms", "5000"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)

    def stop(self):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        return [line.split(", ") for line in out.splitlines() if line]


def _clock_line(samples, span):
    """Print the card's samples taken inside the window ``span``."""
    import datetime
    inside = []
    for c in samples:
        try:
            t = datetime.datetime.strptime(c[0], "%Y/%m/%d %H:%M:%S.%f")
        except (ValueError, IndexError):
            continue
        if span[0] <= t.timestamp() <= span[1] and len(c) >= 4:
            inside.append(c[1:4])
    say(f"[clock] card SM MHz, power W, temperature C every 5 s in the "
        f"window: {inside}")


def _to_np(t):
    return None if t is None else t.detach().float().cpu().numpy()


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None):
    """Run ``cell`` once; returns the result line's dict."""
    import torch
    from volq_torch.engine import loop
    from volq_torch.scene.config import from_json

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else None
    scene = spec.scene(cell, seed)
    cfg = from_json(json.dumps(scene))
    n = int(cell.traffic.get("frames_per_call", 1))
    hooks = tracing.Hooks(sync)
    hooks.install()
    smi = SmiSampler() if cuda else None
    gcw = GcWatch()
    try:
        if cuda:
            say(f"[card] {_smi('name', 'power.limit', 'clocks.max.sm')} "
                "(name, power limit W, max SM MHz)")
        state, camera, light = loop.setup(cfg, dev)
        lv = sb = None
        if cell.traffic.get("cache_banks", True):
            lv = loop.cached_light_volumes(state, light, cfg)
            sb = loop.cached_slab_banks(state, lv, cfg)

        def call(st):
            return loop.frames(st, camera, light, cfg, lv, sb, n=n)

        state, image, _ = call(state)          # builds every kernel
        frames_run = n
        slices = []
        while len(slices) < WARM_SLICES:
            t0, k = time.perf_counter(), 0
            while time.perf_counter() - t0 < WARM_SLICE_S:
                state, image, _ = call(state)
                k += n
            if sync:
                sync()
            slices.append((time.perf_counter() - t0) * 1e3 / k)
            frames_run += k
            say(f"[warmup] slice {len(slices)}: {slices[-1]:.6g} ms/frame "
                f"over {k} frames")
            if len(slices) >= 2 and \
                    abs(slices[-1] - slices[-2]) <= WARM_AGREE * slices[-2]:
                break
        else:
            say(f"[warmup] the last two slices still differ by more than "
                f"{WARM_AGREE:.0%}; the window opens anyway")
        setup_s = time.perf_counter() - t_start
        say(f"[setup] {setup_s:.6g} s from process start, warm-up included")

        win_s = min(seconds, TRACE_SECONDS) if trace else seconds
        first = frames_run
        span = [time.time()]
        if trace:
            summary, span_frames, prof_frames, state, image, wall = \
                _traced_window(call, state, win_s, hooks, sync, cuda)
            win = span_frames + prof_frames
        else:
            state, image, win, wall, per = _window(call, state, win_s, n,
                                                   sync, cuda, gcw)
        span.append(time.time())
        frames_run += win
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if smi:
            _clock_line(smi.stop(), span)
            smi = None

        rows = compare.bands(seed, cfg.render.height,
                             cell.limits["bands"], cell.limits["band_rows"])
        got = {"particles": reference.to_numpy(state.particles),
               "rows": {k: image[k[0]:k[1]].float().cpu().numpy()
                        for k in rows}}
        if cfg.volume.animated:
            dens, lsl = hooks.last["bake_slab_banks"]
            got.update(volumes=_to_np(hooks.last["bake_volumes"]),
                       light=_to_np(hooks.last["render_light_volumes"]),
                       slabs=(_to_np(dens), _to_np(lsl)))
    finally:
        if smi:
            smi.stop()
        gcw.close()
        hooks.uninstall()
    del state, image, lv, sb, camera, light
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the reference, once the window is closed and the program freed
    t_ref = time.perf_counter()
    rcfg = reference.as_config(scene)
    traced = set(range(first + span_frames + 1, first + win + 1)) \
        if trace else set()
    geos = []
    rcam = ref_warp.make_camera(rcfg.camera,
                                rcfg.render.width / rcfg.render.height)

    def on_frame(i, st):
        if i in traced:
            geos.append(ref_warp.geometry(reference.to_numpy(st.particles),
                                          rcam, rcfg))

    rs = reference.replay(rcfg, frames_run, "cpu", on_frame=on_frame,
                          force_device=dev)
    t_sim = time.perf_counter()
    ref = {"particles": reference.to_numpy(rs.particles)}
    vols = light_bank = None
    if rcfg.volume.animated:
        vols, light_bank, slabs = reference.banks(rcfg, rs.time.to(dev),
                                                  dev)
        ref.update(volumes=_to_np(vols), light=_to_np(light_bank),
                   slabs=tuple(_to_np(s) for s in slabs))
    ref["rows"] = reference.render_rows(rcfg, ref["particles"], rows, dev,
                                        vols, light_bank,
                                        workers=len(os.sched_getaffinity(0)))
    del vols, light_bank, rs
    correct, compared = compare.judge(compare.numbers(got, ref),
                                      cell.limits["limits"])
    t_end = time.perf_counter()
    say(f"[reference] {t_end - t_ref:.6g} s ({t_sim - t_ref:.6g} s of "
        f"them the {frames_run} sim steps), rows {rows}")

    res = {"correct": correct, "attempted": win, "failed": 0}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        ctx = dict(spans=hooks.spans, frames=span_frames, summary=summary,
                   cfg=rcfg,
                   bounds=[frame_bounds(rcfg, g, rcfg.volume.size)
                           for g in geos])
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        res["metrics"] = metrics
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
        res["breakdown"] = {
            "device_ops": tracing.top(tracing.short_names(
                summary["kernel_s"])),
            "idle_gaps": tracing.top(summary["idle_s"])}
    else:
        frame_ms = wall * 1e3 / win
        say(f"[window] {win} frames in {wall:.6g} s: frame_ms {frame_ms:.6g}; "
            f"{len(per)} frame samples; Mrays/s "
            f"{cfg.render.width * cfg.render.height / frame_ms / 1e3:.6g}")
        values = {"frame_ms": frame_ms,
                  "frame_ms_p95": float(np.percentile(per, 95)),
                  "setup_s": setup_s}
        res["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
    res["device"] = device_info
    res["compared"] = compared
    return res


def _window(call, state, seconds, n, sync, cuda, gcw):
    """The measured window: from a sync until the first frame that crosses
    ``seconds``, then one sync.  Each call's end is a CUDA event on the
    loop's stream (no sync added); returns (state, image, frames, wall
    seconds, each frame's ms)."""
    import torch
    mhz0 = cpu_mhz()
    if sync:
        sync()
    ends = []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    gcw.on = True
    host = [host_sample() + (0,)]
    t0 = host[0][0]
    win = 0
    while True:
        state, image, _ = call(state)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
        else:
            ends.append(time.perf_counter())
        win += n
        now = time.perf_counter()
        if now - host[-1][0] >= NOISE_SLICE_S:
            host.append(host_sample() + (win,))
        if now - t0 >= seconds:
            break
    if sync:
        sync()
    host.append(host_sample() + (win,))
    wall = time.perf_counter() - t0
    gcw.on = False
    mhz1 = cpu_mhz()
    if cuda:
        calls = [start.elapsed_time(ends[0])] + [
            a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    else:
        calls = [(ends[0] - t0) * 1e3] + [
            (b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    per = [c / n for c in calls for _ in range(n)]
    _noise_lines(per, gcw, mhz0, mhz1, host)
    return state, image, win, wall, per


def _noise_lines(per, gcw, mhz0, mhz1, host):
    med = statistics.median(per)
    slices, acc, cur = [], 0.0, []
    for ms in per:
        cur.append(ms)
        acc += ms
        if acc >= NOISE_SLICE_S * 1e3:
            slices.append(statistics.fmean(cur))
            cur, acc = [], 0.0
    if cur:
        slices.append(statistics.fmean(cur))
    stalls = [ms for ms in per if ms > STALL * med]
    say(f"[slices] frame_ms by {NOISE_SLICE_S:g}-s slice: "
        f"{[round(s, 4) for s in slices]}")
    say(f"[stalls] {len(stalls)} frames over {STALL:g}x the median "
        f"{med:.6g} ms, {sum(stalls):.6g} ms in all; longest "
        f"{max(per):.6g} ms")
    say(f"[gc] passes by generation {gcw.passes} in the window, "
        f"{gcw.ms:.6g} ms")
    say(f"[cpu] pinned to {sorted(os.sched_getaffinity(0))}; cpu MHz at the "
        f"window's start {mhz0} and end {mhz1}")
    rows = []
    for a, b in zip(host, host[1:]):
        fr = max(b[5] - a[5], 1)
        rows.append((round((b[0] - a[0]) * 1e3 / fr, 4),
                     round((b[1] - a[1]) * 1e3 / fr, 4), b[2] - a[2],
                     round(100 * (b[3] - a[3]) / max(b[4] - a[4], 1), 3)))
    say(f"[host] by host-clock slice: (wall ms a frame, process CPU ms a "
        f"frame, involuntary switches, machine steal %): {rows}")


def _frames_in(stats):
    return int(next(iter(stats.values())).shape[0])


def _traced_window(call, state, seconds, hooks, sync, cuda):
    """Two traced passes of ``seconds`` each: synced spans around the layer
    entry points (no profiler), then torch.profiler with annotations only.
    Returns (trace summary, frames of the span pass, frames of the
    profiler pass, state, image, wall seconds of both)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t0 = time.perf_counter()
    if sync:
        sync()
    hooks.on = True
    span_frames = 0
    while time.perf_counter() - t0 < seconds:
        f0 = time.perf_counter()
        state, image, stats = call(state)
        if sync:
            sync()
        hooks.spans.append(("frame", f0, time.perf_counter(), 0))
        span_frames += _frames_in(stats)
    hooks.on = False
    prof_frames = 0
    with tempfile.TemporaryDirectory() as tmp:
        hooks.annotate = True
        with profile(activities=acts) as prof:
            t1 = time.perf_counter()
            while time.perf_counter() - t1 < seconds:
                with record_function("frame"):
                    state, image, stats = call(state)
                prof_frames += _frames_in(stats)
            if sync:
                sync()
        hooks.annotate = False
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        summary = tracing.read_trace(path)
    wall = time.perf_counter() - t0
    if summary is None or (cuda and summary["busy_s"] <= 0):
        raise RuntimeError("the profiler's trace holds no device activity "
                           "in the traced window")
    say(f"[trace] {span_frames} frames with synced spans, then {prof_frames} "
        f"profiled: device busy {summary['busy_s']:.6g} of "
        f"{summary['window_s']:.6g} s")
    return summary, span_frames, prof_frames, state, image, wall
