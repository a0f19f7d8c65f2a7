#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (volq_torch) on one card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without the
final result line):
  1. print the card (nvidia-smi name, power limit) and torch/CUDA versions;
  2. build the four kernels (every mode of each is in its one source) from
     volq_torch/csrc/ (one nvcc per source, in parallel) and print the
     build seconds;
  3. set up preset c3 at full size (1024 particles, 1024 x 128^3 bank,
     1920x1080) and bake its slab banks;
  4. hold kernels A (warp_march) and B (warp_composite) against their
     plain PyTorch versions on the card, at the main path's shapes (all
     1024 particles of a c3 frame), in bf16 (c3's mode) and fp32:
     warp_march within 1e-5 with equal clamp counts, warp_composite
     bit-equal;
  5. drive c3's main path: frames(n=8) from zeroed launch counters, which
     must show one launch of A and B per frame, a finite image with a
     plausible alpha range and rendered particles; time each kernel and
     its plain version at the main path's inputs, and the frame loop
     with engine.loop.time_frames on the state already set up;
  6. set up preset c4 at full size (4096 particles, 64 x 64^3 bank,
     center-lit: the light bake and both slab banks);
  7. hold A and B in center-lit mode (two planes) and the unfused pair,
     kernels C (warp_images) and D (composite_chunk), against their plain
     versions at c4's shapes (4096 particles fused; two megachunks of
     2048 unfused), bf16 (c4's mode) and fp32: A and C within 1e-5 with
     equal clamp counts, B and D bit-equal;
  8. drive c4 as shipped (fused): frames(n=8) from zeroed counters must
     show one launch of A and B per frame; then c4 with warp_fused=False:
     frames(n=4) from zeroed counters must show two launches of C and D
     per frame (warp_mega=2048); both images finite with alpha in [0, 1]
     and rendered particles; the fused and unfused images of one state
     within 1e-4 in fp32 (the two paths are the same math) and, in bf16,
     within the reference's full-frame budget for the c4 class, 6/256
     (the paths round the canvas at different points: the unfused one
     rounds each image to bf16 first and updates T as Tw * (1 - P2), the
     fused one as Tw - Tw * P2); time every kernel, its plain version and
     both c4 loops;
  9. c4 per-step lit (light_mode="march", the reference suite's
     c4:perstep row), fused and with warp_fused=False, on c4's state with
     the full-x slab banks this mode takes: hold A and C in per-step mode
     (and B, D behind them) against their plain versions at c4's full
     shapes, drive both loops from zeroed counters (A 1, B 1 / C 2, D 2
     per frame), compare the fused and unfused images within the budgets
     of phase 8, time the kernels and both loops;
 10. c4 with warp_bands=2, warp_canvas_vmem=1 and, unpaired,
     warp_hazard_passes=1: the image must equal c4's plain image of the
     same state exactly;
 11. set up preset c5 at full size (16384 particles, 16 x 64^3 bank baked
     from 4-D noise, 3840x2160, coarse + interleaved cell canvas,
     center-lit); time the three bakes every c5 frame holds (4-D bank,
     light bank, slab banks); hold A and B at c5's shapes (every particle
     of a frame) in bf16 (c5's mode) and fp32, then each of B's new modes
     alone on a depth-contiguous run of 4096 particles (cell canvas
     without the interleaved association, and the interleaved association
     on a pixel canvas); drive frames(n=4) from
     zeroed counters (A 1, B 1 per frame; every frame re-bakes the
     bank), check the image, time the kernels and the loop;
 12. print the kernels JSON line (per kernel: launches, error, ms, plain
     ms and bound on the c4 path, with the c3, c4 per-step and c5 paths'
     numbers under "c3", "c4_perstep" and "c5"), the card line, and last
     the result line {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.  Without a CUDA device
it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (NVIDIA's data sheet): HBM rate and the
# fp32 rate outside the tensor cores (the kernels are fp32 CUDA-core code)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
N_FRAMES = 8
N_FRAMES_UNFUSED = 4
N_FRAMES_C5 = 4
# depth-contiguous run of particles B's modes are each held on alone
RUN = 4096
# fused vs unfused image of one c4 state: BASELINE.md's on-device budget of
# the c4-class bf16 rows, and the reference's fp32 budget between two paths
BF16_BUDGET = 6 / 256
FP32_BUDGET = 1e-4
NAMES = ("warp_march", "warp_composite", "warp_images", "composite_chunk")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def _with(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, **kw))


def _fp32(cfg):
    return _with(cfg, warp_fp32=True, warp_canvas_fp32=True)


def _wall_ms(fn, reps: int) -> float:
    """Host-clock ms per call of ``fn``, fenced by device synchronizes."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _mode(cfg) -> str:
    return "fp32" if cfg.render.warp_fp32 else "bf16"


def _wrappers():
    from volq_torch.render import kernel as K
    return {"warp_march": K.warp_march, "warp_composite": K.warp_composite,
            "warp_images": K.warp_images,
            "composite_chunk": K.composite_chunk}


def _zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _sub_run(Pm, comp, k0, n):
    """Kernel B's inputs for the depth-contiguous particles [k0, k0+n)."""
    from volq_torch.render import kernel as K
    ayf, axf, box, cc, valid, cp, pdt, cc2 = comp
    sl = slice(k0, k0 + n)
    cut = lambda t: None if t is None else t[sl].contiguous()  # noqa: E731
    sub = K.CompositeParams.from_buffer_copy(cp)
    sub.N = n
    return Pm[sl].contiguous(), (cut(ayf), cut(axf), cut(box), cut(cc),
                                 cut(valid), sub, pdt, cut(cc2))


def _densest_run(comp, n):
    """Start of the run of n depth-consecutive particles with the most
    valid ones."""
    import torch
    valid = comp[4].to(torch.float32)
    if valid.numel() <= n:
        return 0
    csum = torch.cat([valid.new_zeros(1), valid.cumsum(0)])
    return int((csum[n:] - csum[:-n]).argmax())


def check_composite(tag, c, Pm, comp, errs, run=None):
    """Kernel B vs its plain version on ``comp`` (``run``: only on the
    densest depth-contiguous run of that many particles)."""
    import torch
    from volq_torch.render import kernel as K
    H = c.render.height
    if run is not None and run < comp[5].N:
        k0 = _densest_run(comp, run)
        Pm, comp = _sub_run(Pm, comp, k0, run)
        tag += f" particles [{k0}, {k0 + run})"
    cp = comp[5]
    canvas0 = K.canvas_init(c, H, Pm.device)
    out_k = K.warp_composite(canvas0.clone(), Pm, *comp)
    t0 = time.perf_counter()
    out_p = K.warp_composite_plain(canvas0.clone(), Pm, *comp)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    d = float((out_k.float() - out_p.float()).abs().max())
    touched = float((out_k.float() - canvas0.float()).abs().max())
    print(f"[kernels] {tag} warp_composite {_mode(c)} N={cp.N} canvas "
          f"{tuple(out_k.shape)} lit={cp.lit} ilv={cp.ilv} gscale="
          f"{cp.gscale:.6f}: bit-equal {torch.equal(out_k, out_p)}, max diff "
          f"{d:.3e}, max change vs blank canvas {touched:.4f} (plain walk "
          f"{dt:.1f} s)")
    assert torch.equal(out_k, out_p), f"warp_composite {_mode(c)} differs"
    assert touched > 0.0, "warp_composite left the canvas blank"
    errs["warp_composite"] = max(errs["warp_composite"], d)


def check_fused(tag, state, camera, light, cfg, lv, errs):
    """Kernels A and B vs their plain versions at every particle of a
    frame, in the preset's mode and in fp32 (lit when ``lv`` is given)."""
    import torch
    from volq_torch.render import kernel as K
    from volq_torch.render.warp import fused_inputs, bake_slab_banks
    H = cfg.render.height
    for c in (cfg, _fp32(cfg)):
        bank, lbank = bake_slab_banks(state.volumes, lv, c)
        march, comp, _ = fused_inputs(state.particles, camera, light, c,
                                      bank, 0, H, lbank)
        pk, ck = K.warp_march(*march)
        pp, cpl = K.warp_march_plain(*march)
        torch.cuda.synchronize()
        err = float((pk - pp).abs().max())
        print(f"[kernels] {tag} warp_march {_mode(c)} N={march[6].N} "
              f"lit={march[6].lit} planes {tuple(pk.shape)}: "
              f"max|kernel - plain| = {err:.3e}, "
              f"shift_clamped {int(ck[0])} vs {int(cpl[0])}, "
              f"P max {float(pk.max()):.4f}")
        assert err <= 1e-5, f"warp_march {_mode(c)} disagrees: {err}"
        assert int(ck[0]) == int(cpl[0]), "shift_clamped disagrees"
        assert float(pk.max()) > 0.0, "warp_march produced empty planes"
        if lbank is not None:
            shadow = float((pk[:, 1] - pk[:, 0]).max())
            assert shadow > 0.01, "the light sample changed nothing"
        errs["warp_march"] = max(errs["warp_march"], err)
        del pp
        check_composite(tag, c, pk, comp, errs)


def check_unfused(tag, state, camera, light, cfg, lv, errs):
    """Kernels C and D vs their plain versions over every megachunk of a
    frame (the canvas carried from chunk to chunk), bf16 and fp32."""
    import torch
    from volq_torch.render import kernel as K
    from volq_torch.render.warp import unfused_inputs, bake_slab_banks
    H = cfg.render.height
    for c in (cfg, _fp32(cfg)):
        bank, lbank = bake_slab_banks(state.volumes, lv, c)
        chunks, _ = unfused_inputs(state.particles, camera, light, c, bank,
                                   0, H, lbank)
        canvas_k = K.canvas_init(c, H, bank.device, fused=False)
        canvas_p = canvas_k.clone()
        blank = canvas_k.clone()
        for m, (img_args, comp_args) in enumerate(chunks):
            ik, ck = K.warp_images(*img_args)
            ip, cpl = K.warp_images_plain(*img_args)
            torch.cuda.synchronize()
            err = float((ik.float() - ip.float()).abs().max())
            print(f"[kernels] {tag} warp_images {_mode(c)} chunk {m} "
                  f"images {tuple(ik.shape)} {ik.dtype}: max|kernel - plain|"
                  f" = {err:.3e}, shift_clamped {int(ck[0])} vs "
                  f"{int(cpl[0])}, max {float(ik[:, :3].float().max()):.4f}")
            assert err <= 1e-5, f"warp_images {_mode(c)} disagrees: {err}"
            assert int(ck[0]) == int(cpl[0]), "shift_clamped disagrees"
            assert float(ik[:, :3].float().max()) > 0.0, "empty images"
            errs["warp_images"] = max(errs["warp_images"], err)
            del ip
            canvas_k = K.composite_chunk(canvas_k, ik, *comp_args)
            canvas_p = K.composite_chunk_plain(canvas_p, ik, *comp_args)
            torch.cuda.synchronize()
            d = float((canvas_k.float() - canvas_p.float()).abs().max())
            print(f"[kernels] {tag} composite_chunk {_mode(c)} chunk {m}: "
                  f"bit-equal {torch.equal(canvas_k, canvas_p)}, max diff "
                  f"{d:.3e}")
            assert torch.equal(canvas_k, canvas_p), \
                f"composite_chunk {_mode(c)} differs"
            errs["composite_chunk"] = max(errs["composite_chunk"], d)
        assert not torch.equal(canvas_k, blank), "canvas left blank"


def _bound(by, fl):
    t_b, t_f = by / HBM_BYTES_PER_S, fl / FP32_FLOP_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _march_work(args):
    """(bytes in, flops) of the march + fan + exp part of kernels A and C
    on these inputs: the slab stacks of the distinct volumes the valid
    particles use (center-lit: plus one light slab each; per-step lit:
    plus their light stacks), the per-particle scalars and ray vectors;
    per valid ray 12 flops per step telescoped or ~70 per-step lit (two
    samples, two exps, the recurrence), ~80 for the AABB, fan and exps
    (~40 more for the second plane's fan), ~20 for the center light
    sample."""
    import torch
    from volq_torch.render import kernel as K
    bank, vidx, pgeom, mp = args[0], args[1], args[2], args[6]
    valid = pgeom[:, K.PG_VALID] > 0
    nv = int(valid.sum())
    stacks = int(torch.unique(vidx[valid]).numel())
    slab = mp.VX * mp.V * bank.element_size()
    light_slabs = {K.UNLIT: 0, K.CENTER: 1, K.PERSTEP: mp.S}[mp.lit]
    by = (stacks * (mp.S + light_slabs) * slab
          + mp.N * (K.PG_N * 4 + 4 + 2 * mp.RM * 4))
    per_ray = {K.UNLIT: 12 * mp.S + 80, K.CENTER: 12 * mp.S + 100,
               K.PERSTEP: 70 * mp.S + 120}[mp.lit]
    return by, nv * mp.RM * mp.RM * per_ray, nv


def bounds(march, comp, canvas):
    """Least time the card needs for kernels A and B on these inputs:
    max(bytes moved / HBM rate, flops / fp32 rate), in ms.  B's flops
    count the canvas cells inside the valid particles' boxes (~30 per
    cell and plane pair unlit, 52 lit, 44 / 76 with the interleaved
    association's four folded channels)."""
    mp, cp = march[6], comp[5]
    npl = 2 if mp.lit else 1
    a_in, a_flops, nv = _march_work(march)
    a_bytes = a_in + mp.N * npl * mp.RM * mp.RM * 4
    b_bytes = (2 * canvas.numel() * canvas.element_size()
               + nv * npl * mp.RM * mp.RM * 4
               + mp.N * (4 + 4 + 16 + 12 * npl + 4))
    box, valid = comp[2].long(), comp[4] > 0
    cells = int(((box[:, 1] - box[:, 0]).clamp(min=0)
                 * (box[:, 3] - box[:, 2]).clamp(min=0))[valid].sum())
    per_cell = {(1, 0): 30, (2, 0): 52, (1, 1): 44, (2, 1): 76}[npl, cp.ilv]
    return {"warp_march": _bound(a_bytes, a_flops),
            "warp_composite": _bound(b_bytes, cells * per_cell)}


def bounds_unfused(chunks, canvas, itemsize):
    """Least time for one frame's launches of kernels C and D (summed
    over the megachunks), divided by the launches: the images written by
    C and read by D dominate; D also moves the canvas in and out."""
    c_by = c_fl = d_by = d_fl = 0
    for img_args, comp_args in chunks:
        mp = img_args[6]
        npl = 2 if mp.lit else 1
        m_in, m_fl, nv = _march_work(img_args)
        img_bytes = mp.N * 4 * mp.RP * mp.RP * itemsize
        c_by += m_in + mp.N * 12 + img_bytes
        c_fl += m_fl + nv * (npl * 4 * (mp.RP * mp.RM + mp.RP * mp.RP)
                             + 13 * mp.RP * mp.RP)
        d_by += (img_bytes + 2 * canvas.numel() * canvas.element_size()
                 + mp.N * 12)
        d_fl += mp.N * mp.RP * mp.RP * 7
    n = len(chunks)
    return {"warp_images": _bound(c_by / n, c_fl / n),
            "composite_chunk": _bound(d_by / n, d_fl / n)}


def check_image(tag, image, stats, cfg):
    import torch
    H, W = cfg.render.height, cfg.render.width
    assert tuple(image.shape) == (H, W, 4), image.shape
    assert bool(torch.isfinite(image).all()), "non-finite pixels"
    alpha = image[..., 3]
    a_min, a_max = float(alpha.min()), float(alpha.max())
    cover = float((alpha > 0.01).float().mean())
    print(f"[main] {tag} alpha in [{a_min:.4f}, {a_max:.4f}], "
          f"{cover * 100:.1f}% of pixels above 0.01")
    assert a_min >= 0.0 and a_max <= 1.0 + 1e-6 and a_max > 0.05
    assert int(stats["rendered"][-1]) > 0


def drive(tag, state, camera, light, cfg, lv, sb, n, expect):
    """frames(n) from zeroed launch counters; the counts must equal
    ``expect`` (per frame) times n.  Returns (state, image, counts)."""
    import torch
    from volq_torch.engine import loop
    _zero_counts()
    t0 = time.perf_counter()
    state, image, stats = loop.frames(state, camera, light, cfg, lv, sb, n=n)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counts()
    print(f"[main] {tag} frames(n={n}) in {dt:.3f} s, launches {counts}, "
          f"stats of the last frame "
          f"{ {k: int(v[-1]) for k, v in stats.items()} }")
    for name in NAMES:
        want = expect.get(name, 0) * n
        assert counts[name] == want, \
            f"{tag}: {name} launched {counts[name]} times in {n} frames, " \
            f"expected {want}"
    check_image(tag, image, stats, cfg)
    return state, image, counts


def same_image(tag, state, camera, light, cfg, ucfg, lv, sb):
    """One state through the fused and the unfused path, in the preset's
    bf16 mode and in fp32: the images agree within the budgets."""
    from volq_torch.render.warp import bake_slab_banks, render_warp
    for budget, conv in ((BF16_BUDGET, lambda c: c), (FP32_BUDGET, _fp32)):
        banks = sb if conv(cfg) is cfg else bake_slab_banks(
            state.volumes, lv, conv(cfg))
        img_f, img_u = (render_warp(state.particles, state.volumes, camera,
                                    light, conv(c), light_volumes=lv,
                                    slab_banks=banks)[0]
                        for c in (cfg, ucfg))
        d = float((img_f - img_u).abs().max())
        print(f"[main] {tag} fused vs unfused image of one state, "
              f"{_mode(conv(cfg))}: max diff {d:.3e} (budget {budget:.3e})")
        assert d <= budget, f"fused and unfused {tag} images differ by {d}"


def time_fused(tag, state, camera, light, cfg, sb, card):
    """ms of A, B and their plain versions at the state's inputs, and
    their bounds.  ``sb`` None (animated scenes): the state's banks are
    baked here, as the frame does."""
    from volq_torch.engine import loop
    from volq_torch.render import kernel as K
    from volq_torch.render.warp import fused_inputs, bake_slab_banks
    H = cfg.render.height
    if sb is None:
        sb = bake_slab_banks(state.volumes,
                             loop._light_volumes(state, light, cfg), cfg)
    march, comp, _ = fused_inputs(state.particles, camera, light, cfg,
                                  sb[0], 0, H, sb[1])
    Pm, _ = K.warp_march(*march)
    canvas = K.canvas_init(cfg, H, Pm.device)
    ms = {"warp_march": _cuda_ms(lambda: K.warp_march(*march), 20),
          "warp_composite": _cuda_ms(
              lambda: K.warp_composite(canvas, Pm, *comp), 20)}
    plain = {"warp_march": _cuda_ms(lambda: K.warp_march_plain(*march), 3),
             "warp_composite": _cuda_ms(
                 lambda: K.warp_composite_plain(canvas, Pm, *comp), 1)}
    bnd = bounds(march, comp, canvas)
    for name in ms:
        print(f"[timing] {tag} {name}: kernel {ms[name]:.4f} ms, plain "
              f"{plain[name]:.3f} ms, bound {bnd[name][0]:.4f} ms "
              f"({bnd[name][1]})  [{card}]")
    return {name: {"ms": ms[name], "plain_ms": plain[name],
                   "bound_ms": bnd[name][0], "bound_by": bnd[name][1]}
            for name in ms}


def time_unfused(tag, state, camera, light, cfg, sb, card):
    """ms per launch of C, D and their plain versions (the mean over the
    frame's megachunks), and their bounds."""
    from volq_torch.render import kernel as K
    from volq_torch.render.warp import unfused_inputs
    H = cfg.render.height
    chunks, _ = unfused_inputs(state.particles, camera, light, cfg, sb[0],
                               0, H, sb[1])
    canvas = K.canvas_init(cfg, H, sb[0].device, fused=False)
    n = len(chunks)
    ms = dict.fromkeys(("warp_images", "composite_chunk"), 0.0)
    plain = dict(ms)
    for img_args, comp_args in chunks:
        images, _ = K.warp_images(*img_args)
        ms["warp_images"] += _cuda_ms(
            lambda: K.warp_images(*img_args), 10) / n
        ms["composite_chunk"] += _cuda_ms(
            lambda: K.composite_chunk(canvas, images, *comp_args), 10) / n
        plain["warp_images"] += _cuda_ms(
            lambda: K.warp_images_plain(*img_args), 2) / n
        plain["composite_chunk"] += _cuda_ms(
            lambda: K.composite_chunk_plain(canvas, images, *comp_args),
            1) / n
    bnd = bounds_unfused(chunks, canvas, sb[0].element_size())
    for name in ms:
        print(f"[timing] {tag} {name} (per launch, {n} per frame): kernel "
              f"{ms[name]:.4f} ms, plain {plain[name]:.3f} ms, bound "
              f"{bnd[name][0]:.4f} ms ({bnd[name][1]})  [{card}]")
    return {name: {"ms": ms[name], "plain_ms": plain[name],
                   "bound_ms": bnd[name][0], "bound_by": bnd[name][1]}
            for name in ms}


def time_loop(tag, prepared, cfg, card, fb=N_FRAMES, n_frames=16, warmup=1):
    from volq_torch.engine import loop
    band = []
    spf, _ = loop.time_frames(cfg, n_frames, warmup=warmup, fb=fb, windows=3,
                              window_times=band, prepared=prepared)
    mrays = cfg.render.width * cfg.render.height / spf / 1e6
    print(f"[loop] {tag} time_frames: {spf * 1e3:.3f} ms/frame, "
          f"{mrays:.2f} Mrays/s (windows "
          f"{[round(w * 1e3, 3) for w in band]} ms/frame)  [{card}]")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from volq_torch.engine import loop
    from volq_torch.render._build import build_all
    from volq_torch.render import kernel as K
    from volq_torch.render.warp import (bake_slab_banks, fused_inputs,
                                        render_warp)
    from volq_torch.scene.config import c3, c4, c5
    from volq_torch.scene.state import bake_volumes
    from volq_torch.sim.step import sim_step

    card = _card_line()
    print(f"[card] {card}")
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")

    t = build_all(verbose=True)
    print(f"[build] kernels built in {t:.1f} s")
    errs = dict.fromkeys(NAMES, 0.0)

    # ---- c3: the unlit fused path
    cfg = c3()
    t0 = time.perf_counter()
    state, camera, light = loop.setup(cfg)
    torch.cuda.synchronize()
    print(f"[setup] c3 setup (bank bake {tuple(state.volumes.shape)} "
          f"{state.volumes.dtype} + particle init): "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sb = loop.cached_slab_banks(state, None, cfg)
    torch.cuda.synchronize()
    print(f"[setup] c3 slab banks {tuple(sb[0].shape)} {sb[0].dtype}: "
          f"{time.perf_counter() - t0:.2f} s")
    # inputs of the first frame, for the kernel checks
    check_fused("c3", sim_step(state, cfg), camera, light, cfg, None, errs)
    fused = {"warp_march": 1, "warp_composite": 1}
    unfused = {"warp_images": 2, "composite_chunk": 2}
    state, _, c3_counts = drive("c3", state, camera, light, cfg, None, sb,
                                N_FRAMES, fused)
    c3_times = time_fused("c3", state, camera, light, cfg, sb, card)
    time_loop("c3", (state, camera, light, None, sb), cfg, card)
    del state, sb
    torch.cuda.empty_cache()

    # ---- c4: center-lit, as shipped (fused) and with warp_fused=False
    cfg = c4()
    ucfg = _with(cfg, warp_fused=False)
    t0 = time.perf_counter()
    state, camera, light = loop.setup(cfg)
    torch.cuda.synchronize()
    print(f"[setup] c4 setup (bank bake {tuple(state.volumes.shape)} "
          f"{state.volumes.dtype} + particle init): "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lv = loop.cached_light_volumes(state, light, cfg)
    sb = loop.cached_slab_banks(state, lv, cfg)
    torch.cuda.synchronize()
    print(f"[setup] c4 light bake {tuple(lv.shape)} {lv.dtype} + slab banks "
          f"{tuple(sb[0].shape)} x 2 {sb[0].dtype}: "
          f"{time.perf_counter() - t0:.2f} s")
    assert sb[1] is not None and sb[1].shape == sb[0].shape
    st1 = sim_step(state, cfg)
    check_fused("c4", st1, camera, light, cfg, lv, errs)
    check_unfused("c4", st1, camera, light, ucfg, lv, errs)

    st_f, _, c4_counts = drive("c4 fused", state, camera, light, cfg, lv,
                               sb, N_FRAMES, fused)
    st_u, _, u_counts = drive("c4 unfused", state, camera, light, ucfg, lv,
                              sb, N_FRAMES_UNFUSED, unfused)
    same_image("c4", st_u, camera, light, cfg, ucfg, lv, sb)
    c4_times = time_fused("c4", st_f, camera, light, cfg, sb, card)
    c4_times.update(time_unfused("c4", st_f, camera, light, ucfg, sb, card))
    for tag, st, c in (("c4 fused", st_f, cfg), ("c4 unfused", st_u, ucfg)):
        time_loop(tag, (st, camera, light, lv, sb), c, card)

    # ---- c4 with bands, the resident-canvas flag and the hazard reorder
    img, stats = render_warp(st_f.particles, st_f.volumes, camera, light,
                             cfg, light_volumes=lv, slab_banks=sb)
    for kw in (dict(warp_bands=2, warp_canvas_vmem=1),
               dict(warp_pair=0, warp_hazard_passes=1)):
        alt, st_alt = render_warp(st_f.particles, st_f.volumes, camera,
                                  light, _with(cfg, **kw),
                                  light_volumes=lv, slab_banks=sb)
        print(f"[main] c4 with {kw}: image equal to c4's "
              f"{torch.equal(alt, img)}, rendered {int(st_alt['rendered'])} "
              f"vs {int(stats['rendered'])}")
        assert torch.equal(alt, img), f"{kw} changed the image"
    del img, alt

    # ---- c4 per-step lit (light_mode="march"), fused and unfused
    pcfg = _with(cfg, light_mode="march")
    pucfg = _with(pcfg, warp_fused=False)
    psb = loop.cached_slab_banks(state, lv, pcfg)
    print(f"[setup] c4 per-step slab banks {tuple(psb[0].shape)} x 2 "
          f"{psb[0].dtype}")
    assert psb[1].shape == psb[0].shape and psb[0].shape[2] == 64
    check_fused("c4 per-step", st1, camera, light, pcfg, lv, errs)
    check_unfused("c4 per-step", st1, camera, light, pucfg, lv, errs)
    del st1
    sp_f, _, p_counts = drive("c4 per-step fused", state, camera, light,
                              pcfg, lv, psb, N_FRAMES, fused)
    sp_u, _, pu_counts = drive("c4 per-step unfused", state, camera, light,
                               pucfg, lv, psb, N_FRAMES_UNFUSED, unfused)
    p_counts = dict(pu_counts, warp_march=p_counts["warp_march"],
                    warp_composite=p_counts["warp_composite"])
    same_image("c4 per-step", sp_u, camera, light, pcfg, pucfg, lv, psb)
    p_times = time_fused("c4 per-step", sp_f, camera, light, pcfg, psb, card)
    p_times.update(time_unfused("c4 per-step", sp_f, camera, light, pucfg,
                                psb, card))
    for tag, st, c in (("c4 per-step fused", sp_f, pcfg),
                       ("c4 per-step unfused", sp_u, pucfg)):
        time_loop(tag, (st, camera, light, lv, psb), c, card)
    del state, st_f, st_u, sp_f, sp_u, sb, psb, lv
    torch.cuda.empty_cache()

    # ---- c5: animated 4-D bank, coarse + interleaved cell canvas, 4K
    cfg = c5()
    t0 = time.perf_counter()
    state, camera, light = loop.setup(cfg)
    torch.cuda.synchronize()
    print(f"[setup] c5 setup (4-D bank bake {tuple(state.volumes.shape)} "
          f"{state.volumes.dtype} + particle init): "
          f"{time.perf_counter() - t0:.2f} s")
    assert loop.cached_light_volumes(state, light, cfg) is None
    assert loop.cached_slab_banks(state, None, cfg) is None
    st1 = sim_step(state, cfg)
    lv = loop._light_volumes(st1, light, cfg)
    for what, fn in (
            ("4-D bank bake", lambda: bake_volumes(cfg, "cuda", st1.time)),
            ("light bake", lambda: loop._light_volumes(st1, light, cfg)),
            ("slab bake (both banks)",
             lambda: bake_slab_banks(st1.volumes, lv, cfg))):
        print(f"[bake] c5 {what}: {_wall_ms(fn, 3):.3f} ms per frame  "
              f"[{card}]")
    check_fused("c5", st1, camera, light, cfg, lv, errs)
    # B's new modes each alone, on a run of particles: the cell canvas
    # without the interleaved association, and that association on a
    # pixel canvas
    for tag, c in (("c5 cells, planes", _with(cfg, warp_interleave=0)),
                   ("c5 pixels, ilv", _with(cfg, warp_coarse=0))):
        bank, lbank = bake_slab_banks(st1.volumes, lv, c)
        march, comp, _ = fused_inputs(st1.particles, camera, light, c, bank,
                                      0, c.render.height, lbank)
        Pm, _ = K.warp_march(*march)
        check_composite(tag, c, Pm, comp, errs, run=RUN)
    del st1, lv, bank, lbank, march, comp, Pm
    torch.cuda.empty_cache()
    state, _, c5_counts = drive("c5", state, camera, light, cfg, None, None,
                                N_FRAMES_C5, fused)
    c5_times = time_fused("c5", state, camera, light, cfg, None, card)
    time_loop("c5", (state, camera, light, None, None), cfg, card,
              fb=N_FRAMES_C5, n_frames=N_FRAMES_C5, warmup=0)

    sources = {name: f"volq_torch/csrc/{name}.cu" for name in NAMES}
    replaces = {"warp_march": "volq/render/kernel.py:175",
                "warp_composite": "volq/render/kernel.py:175",
                "warp_images": "volq/render/kernel.py:2013",
                "composite_chunk": "volq/render/kernel.py:2159"}
    launches = dict(u_counts, warp_march=c4_counts["warp_march"],
                    warp_composite=c4_counts["warp_composite"])
    kernels = []
    for name in NAMES:
        k = {"name": name, "route": "cuda", "source": sources[name],
             "replaces": replaces[name], "launches": launches[name],
             "max_abs_err": errs[name], **c4_times[name],
             "library_ms": None, "path": "c4"}
        # the other paths through the same kernel
        for path, counts, times in (("c3", c3_counts, c3_times),
                                    ("c4_perstep", p_counts, p_times),
                                    ("c5", c5_counts, c5_times)):
            if name in times:
                k[path] = {"launches": counts[name], **times[name]}
        kernels.append(k)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
