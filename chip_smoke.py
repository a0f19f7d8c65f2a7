#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (volq_torch) on one card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without the
final result line):
  1. print the card (nvidia-smi name, power limit) and torch/CUDA versions;
  2. build the ten kernel sources (every mode of each is in its one source)
     from volq_torch/csrc/ (one nvcc per source, in parallel) and print
     the build seconds;
  2a. the probes: hold both arms of probe_mma (mma_sync, wgmma) against
     its fp64 plain version within 1e-4 of max |out| (G 4 at the stack
     depth R of the timed launches, seven shapes that exercise every wgmma
     plan -- transposed, padded, streamed through the ring, n16, N 256 --
     nacc 1 and 8, 1 and 132 blocks), both arms of probe_stage (cp_async;
     tma at ring depths 2, 4 and 8 where the ring fits) bit-equal (K 1, 4,
     12, with small and const stacks) and both arms of probe_window
     (cp_async at align 128, 16, 8, 4; tma also at 2 and 1) bit-equal on
     the reference's 4096 windows of a 1088 x 2048 canvas and on the
     heavy-overlap cases (window.overlap_cases: one band, identical
     windows, x near the edge, x at 0 or W - 128); read the SASS of the
     probes (python -m volq_torch.sass): HGMMA and UTMALDG in every
     wgmma-arm function, UBLKCP in probe_stage's tma arm, UTMALDG and
     UTMASTG in probe_window's, LDGSTS in their cp_async arms, and no block
     barrier (BAR) in the loops of either arm of probe_stage and
     probe_window; then run the probes' entry point
     (python -m volq_torch.probe, in process) from zeroed launch counters:
     every probe and every arm must have launched, and no printed
     tensor-core rate may exceed the card's 989 TFLOP/s;
  2b. the command line, in process, on the card: preset c1 as shipped (the
     exact engine), 2 frames with --png --npy --checkpoint, then --resume
     for one more frame, which must equal the third frame of an
     uninterrupted 3-frame run; c1's first frame against the same frame
     with --device cpu within 1e-5; c1 through the warp engine at full
     size (256 x 256 ortho, 32 steps, V 32, march rect 128), (i) with
     render.engine=warp (the XLA path: no kernel launches) and (ii) with
     warp_pallas=true (A and B in their orthographic mode: one launch
     each), each against --device cpu within 1e-5 and (i) against (ii)
     within the reference's fp32 budget 1e-5, then both timed with
     time_frames, and A and B timed alone at c1's shapes against their
     plain versions and bounds (B's canvas must equal its plain
     version's); preset c2 as shipped (512 x 512 warp) from zeroed
     counters, which must show launches of A and B and a plausible image;
  2c. preset c2 as shipped and with warp_pallas=false (the XLA path in
     plain torch): frames from zeroed counters (A 1, B 1 per frame / no
     kernel), the two paths' images of one state within 6/256 in bf16
     and 1e-4 in fp32, A and B timed against their bounds on c2's inputs,
     both loops timed (ms/frame side by side);
  2d. the slab engine (plain torch, no kernel): c1 with engine=slab in
     fp32 against --device cpu within 1e-5 and against the slab oracle
     (volq_torch/render/slab_oracle.py, the reference's, copied) within
     the reference's 1e-3 on the full 256 x 256 frame; c2 at full size
     with engine=slab, slab_fp32=False against --device cpu within 1e-3
     (and in fp32 within 1e-5) and against the quantized oracle on the
     64 x 64 window at the
     frame's centre within BASELINE.md's c2_slab_bf16_full budget
     0.0156; c2 with slab_grouped (the port marches it pairwise: see
     render/slab.py) against c2 within 1e-5; the two loops timed; then
     the unsharded frames the mesh phase holds its sharded ones to (c1
     exact, c2 slab bf16);
     the command line's --mesh 1 runs in phase 2b (c1: its second frame
     against the unsharded run's within 1e-5);
  3. set up preset c3 at full size (1024 particles, 1024 x 128^3 bank,
     1920x1080) and bake its slab banks; 2 frames of c3 with
     warp_canvas_fp32=true (the sharded frame's reference) and its loop
     timed;
  4. hold kernels A (warp_march) and B (warp_composite) against their
     plain PyTorch versions on the card, at the main path's shapes (all
     1024 particles of a c3 frame), in bf16 (c3's mode) and fp32:
     warp_march within 1e-5 with equal clamp counts, warp_composite
     bit-equal;
  5. drive c3's main path: frames(n=8) from zeroed launch counters, which
     must show one launch of A and B per frame, a finite image with a
     plausible alpha range and rendered particles; time each kernel and
     its plain version at the main path's inputs (B's plain version walks
     the frame's particles once: that walk is timed and its canvas must
     equal the kernel's, here and on every later path), and the frame loop
     with engine.loop.time_frames on the state already set up; then the
     command line's --bench --frames 16 --frames-per-launch 8 on that same
     state (its one JSON line parsed, mrays_per_s > 0);
  5b. c3's state and slab banks under an orthographic camera whose half
     height frames the alive particles (printed): A in its ortho mode and
     B held against their plain versions as in phase 4, frames(n=8) from
     zeroed counters (A 1, B 1 per frame), A and B timed;
  6. set up preset c4 at full size (4096 particles, 64 x 64^3 bank,
     center-lit: the light bake and both slab banks);
  7. hold A and B in center-lit mode (two planes) and the unfused pair,
     kernels C (warp_images) and D (composite_chunk), against their plain
     versions at c4's shapes (4096 particles fused; two megachunks of
     2048 unfused), bf16 (c4's mode) and fp32: A within 1e-5 and C at
     max abs err 0, each with equal clamp counts, B and D bit-equal;
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
  9b. c4 with warp_fused=False under an orthographic camera framing its
     particles: C in its ortho mode and D held against their plain
     versions as in phase 7, frames(n=4) from zeroed counters (C 2, D 2
     per frame), C and D timed;
 10. c4 with warp_bands=2, warp_canvas_vmem=1 and, unpaired,
     warp_hazard_passes=1: the image must equal c4's plain image of the
     same state exactly;
 11. set up preset c5 at full size (16384 particles, 16 x 64^3 bank baked
     from 4-D noise, 3840x2160, coarse + interleaved cell canvas,
     center-lit); time the three bakes every c5 frame holds (4-D bank,
     light bank, slab banks); hold the noise kernel (noise_bake) bit-equal
     to its plain version on the 4-D bank, and time both and its bound
     (noise_bake_work: the operations a voxel counted by hand, by pipe;
     noise_bake_bound: the largest of issue slots, FMA pipe, int32 ALU,
     conversions and bytes), its SASS's instructions beside it
     (noise_bake_sass); hold the sim's kernels (sim_step.cu) bit-equal to
     the plain sim step over 4 steps of c5's particles aged so that slots
     die and respawn (check_sim_kernel: 3 launches a step), time them
     (events, a CUDA-graph replay, the host clock) and the plain step,
     and their bound (sim_step_work, sim_step_bound); hold the light
     kernel (light_bake.cu) bit-equal to the plain sweep on c5's bank
     (check_light_kernel: 1 launch), time both (events, a CUDA-graph
     replay) and its bound (light_bake_work, light_bake_bound: bytes,
     operations, the chain of V - 1 steps); hold A at c5's
     shapes (every particle of a
     frame) in bf16 (c5's mode) and fp32, and B in both on the densest
     depth-contiguous run of 4096 particles (its plain version walks the
     16384 particles of a whole frame in most of a minute), then each of
     B's new modes alone on such a run (cell canvas without the
     interleaved association, and the interleaved association on a pixel
     canvas); drive frames(n=4) from zeroed counters (A 1, B 1, the
     noise kernel 1 and the light kernel 1 per frame: every frame
     re-bakes the bank and its light bank; the other configs' drives 0
     noise- and light-kernel launches, their banks baked at set-up;
     every drive 3 sim-kernel launches a frame; c5's frames under the
     profiler's CPU tracing, so that the program's counters count: no
     blocking copy, h2d + d2h 0, and const_miss 0 -- the configuration's
     constants were made once by the frames and checks before and come
     from core/device.const's cache), check the image,
     time the kernels and
     the loop: the one timed walk of B's plain version holds B on every
     particle of a c5 frame;
 11b. the sharded frame (dist/) at mesh size 1 on the card, one rank
     process over NCCL: make_mesh of one rank more than the card count
     raises naming the count; c1 exact, c2 slab bf16, c3 and c5 (each
     with warp_canvas_fp32=true, c5 after its own reference frames in
     phase 11) run 2 frames each in one rank process (loop.run_sharded),
     each image within 1e-5 and each particle state within 1e-6 of the
     unsharded frames, alive and pairs_kept equal, A and B launched once
     a frame through the sharded route on c3 and c5 (the rank's own
     counters, zeroed after its set-up), none on c1 and c2; in that rank
     process each config's unsharded and mesh-1 loops timed in turns
     (MESH_TIMING: 16 frames a window, 4 a call, one warm-up call, three
     turns), the medians side by side; time_frames(mesh=1) on c1 (the
     entry point, a rank process of its own);
 12. print the kernels JSON line, twelve entries (per warp kernel:
     launches, error, ms, plain ms and bound on the c4 path, with the c1
     warp, c2, c3, ortho, c4 per-step and c5 paths' numbers under
     "c1_warp", "c2", "c3", "c3_ortho", "c4_ortho", "c4_perstep" and
     "c5"; A and B also under "c3_mesh1" and "c5_mesh1", their
     launches through the sharded frame at mesh 1 and its ms/frame; for
     every warp kernel also "device_ms", its time replayed
     from a CUDA graph (without the Python wrappers' host time); for A, C
     and D the SM clock while their launches run ("sm_mhz"); A's and
     C's arm, ring depth and block size (C also its y-pass band and
     shared bytes), B's and D's "fill_ms" (the first of their two
     kernels, the lists' fill, alone) and list slots, their
     "sub_tile_visits" (the 4 x 32 warp sub-tiles the valid boxes / the
     images' rects meet, summed), D's longest list; on c3, c4, c4
     per-step and c5 A's, and on c4 and c4 per-step unfused C's,
     "sweep_ms": a ring of two and the widest blocks, each output equal
     to the planned launch's (the [sweep] lines); the [timing]
     lines also print each kernel's reading in the last run before C's
     and D's redesign (PREV_MS, a prior run's, not this run's);
     "warp_march ortho" and
     "warp_images ortho": A's and C's orthographic mode on the c3 and c4
     ortho paths; "noise_bake" on c5's bank (launches over the c5
     drive's "frames", ms, device ms, plain ms, bound and its terms,
     operations a voxel, its SASS's counts); "sim_step" on c5's
     particles (launches over the c5 drive's "frames", ms, device ms,
     host-clock ms, plain ms, bound and its terms, the work counted);
     "light_bake" on c5's bank (launches over the c5 drive's "frames",
     ms, device ms, plain ms, bound and its terms, the work counted); per
     probe kernel: launches of the probes' run, error,
     and ms, plain ms, bound at one named point -- for probe_mma and
     probe_stage the new arm's (wgmma, tma) with the old arm's ms beside
     it under the arm's name; probe_stage's bound the largest of bytes,
     operations and its chain of G dependent fp32 adds at the SM clock
     read under the launch; probe_mma's library time one torch.matmul of
     the same sums, the R operands side by side along K ([Bt, M, R K] @
     [R K, N], B stacked R times), Bt copies whose operands stay in L2,
     replayed from a CUDA graph and scaled per product; probe_window's
     bound the larger of bytes and its chain -- the longest run of
     windows each overlapping an earlier one, times one dependent L2 round
     trip timed on the card -- and its library time the fastest of
     index_add_, scatter_add_ and index_put_(accumulate=True) at the
     windows' cell indices, held bit-equal to the plain version),
     the card line, and last the result line {"ok": true, "device":
     {...}}.

It imports nothing of JAX or of the JAX package.  Without a CUDA device
it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM data-sheet peaks (NVIDIA's data sheet): HBM rate and the
# fp32 rate outside the tensor cores (the kernels are fp32 CUDA-core code)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# per-SM rates a clock on compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput), x 132 SMs at the 1980-MHz
# boost clock: warp instructions issued (4 schedulers x 32 lanes), single
# fp32 adds and multiplies (an FMA would count two), int32 adds, shifts and
# logic, int32 multiplies (IMAD, on the FMA pipe beside the fp32 work),
# type conversions (I2F, F2I, FRND, F2F)
SM_CLOCKS_PER_S = 132 * 1.98e9
ISSUE_PER_SM, FP32_PER_SM, INT32_PER_SM, IMUL_PER_SM, CONVERT_PER_SM = \
    128, 128, 64, 64, 16
BF16_FLOP_PER_S = 989e12    # dense, tensor cores
N_FRAMES = 8
N_FRAMES_UNFUSED = 4
N_FRAMES_C5 = 4
# launches of the sim's kernels a step (csrc/sim_step.cu)
SIM_LAUNCHES = 3
# fp64 operations an SM a clock on compute capability 9.0 (the same guide)
FP64_PER_SM = 64
# depth-contiguous run of particles B's modes are each held on alone
RUN = 4096
# fused vs unfused image of one c4 state: BASELINE.md's on-device budget of
# the c4-class bf16 rows, and the reference's fp32 budget between two paths
BF16_BUDGET = 6 / 256
FP32_BUDGET = 1e-4
# the XLA warp path against the Pallas path: the reference's fp32 budget
# (tests/test_warp.py:233)
XLA_BUDGET = 1e-5
NAMES = ("warp_march", "warp_composite", "warp_images", "composite_chunk")
# the slab engine against its oracle: the reference's fp32 budget
# (tests/test_slab.py:18) and its on-device bf16 budget for c2 through the
# slab engine (BASELINE.md's device-diff table, c2_slab_bf16_full)
SLAB_TOL = 1e-3
SLAB_BF16_TOL = 0.0156
# card against --device cpu, grouped against pairwise, and the sharded
# frame against the unsharded one: the reference's 1e-5.  In bf16 the
# card and the CPU round a hat weight or a slab cell differently wherever
# their fp32 inputs differ by an ulp (0.000229 on c2, NVIDIA H100 80GB
# HBM3 against the host CPU): that pair is held to the reference's
# per-pixel budget SLAB_TOL, and to SAME_TOL in fp32 on the same frame
SAME_TOL = 1e-5
# c2's 64 x 64 centre window, (x0, y0, w, h), for the bf16 oracle
C2_WINDOW = (224, 224, 64, 64)
# frames of each config the mesh phase holds against the unsharded loop
N_FRAMES_MESH = 2
# the mesh phase's timing of each config's unsharded and mesh-1 loops in
# the rank process: (frames a window, frames a call, warm-up calls,
# turns), one window of each loop a turn
MESH_TIMING = (16, 4, 1, 3)
# Each kernel's ms per launch on each path in this script's last run
# before C's redesign onto A's march and D's onto per-tile lists (NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md section 5), printed on the [timing]
# lines beside this run's, labelled as that run's
PREV_MS = {
    "c1 warp": {"warp_march": 0.1431, "warp_composite": 0.0473},
    "c2": {"warp_march": 0.0877, "warp_composite": 0.0563},
    "c3": {"warp_march": 0.2978, "warp_composite": 0.1732},
    "c3 ortho": {"warp_march": 0.2734, "warp_composite": 0.1855},
    "c4": {"warp_march": 0.8486, "warp_composite": 0.5737,
           "warp_images": 1.6058, "composite_chunk": 0.2015},
    "c4 per-step": {"warp_march": 1.4416, "warp_composite": 0.5735,
                    "warp_images": 2.5816, "composite_chunk": 0.2014},
    "c4 ortho": {"warp_images": 1.4449, "composite_chunk": 0.1950},
    "c5": {"warp_march": 5.0899, "warp_composite": 2.3870}}
# operand bytes of the torch.matmul that times probe_mma's library call:
# its batch stays in L2 (50 MB) from one call to the next
LIB_L2_BYTES = 40e6
PROBES = ("probe_mma", "probe_stage", "probe_window")
# probe_mma against its fp64 plain version, relative to max |out|
MMA_TOL = 1e-4


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def _cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Device ms per call of ``fn`` (``warm=False``: no untimed first call,
    for the plain versions that are seconds-long Python loops)."""
    import torch
    if warm:
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


def ortho_view(cfg, state, camera):
    """``cfg`` under an orthographic camera (same eye and look-at) whose
    half height frames the alive particles: the larger of their extent
    along up and their extent along right over the aspect, plus 5%.
    Returns (config, camera on the card, half height)."""
    import torch
    from volq_torch.scene.state import build_camera
    p = state.particles
    alive = p.age < p.lifetime
    rel = (p.pos.float() - camera.eye)[alive]
    half = p.size.float()[alive]
    ext_x = float(((rel * camera.right).sum(-1).abs() + half).max())
    ext_y = float(((rel * camera.up).sum(-1).abs() + half).max())
    aspect = cfg.render.width / cfg.render.height
    hh = round(max(ext_y, ext_x / aspect) * 1.05, 3)
    ocfg = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, projection="ortho", ortho_half_h=hh))
    cam = build_camera(ocfg.camera, cfg.render.width, cfg.render.height,
                       torch.device("cuda"))
    return ocfg, cam, hh


# the C functions of the kernels that launch through more than one, as
# ``_build.launches`` counts them: the sim step's three, each probe's arms
# in the order of its ARMS; every other kernel's is "<kernel>_launch"
LAUNCHES = {
    "sim_step": ("sim_scan_launch", "sim_spawn_launch", "sim_forces_launch"),
    "probe_mma": ("probe_mma_launch", "probe_mma_wgmma_launch"),
    "probe_stage": ("probe_stage_launch", "probe_stage_tma_launch"),
    "probe_window": ("probe_window_launch", "probe_window_tma_launch")}


def _counts():
    """Launches by kernel since the last ``_build.launches.clear()``."""
    from volq_torch import _build
    return {name: sum(_build.launches[f]
                      for f in LAUNCHES.get(name, (f"{name}_launch",)))
            for name in NAMES + ("noise_bake", "sim_step", "light_bake")
            + PROBES}


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


def check_fused(tag, state, camera, light, cfg, lv, errs, run=None):
    """Kernels A and B vs their plain versions at every particle of a
    frame, in the preset's mode and in fp32 (lit when ``lv`` is given).
    ``run``: B's plain walk takes only the densest depth-contiguous run of
    that many particles (time_fused holds B on the whole frame)."""
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
        check_composite(tag, c, pk, comp, errs, run=run)


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
            assert err == 0.0, f"warp_images {_mode(c)} disagrees: {err}"
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


def noise_bake_work(n: int, size: int, octaves: int, dim: int) -> dict:
    """Operations by the pipe that executes them, and bytes, of a noise
    bank of ``n`` entries of ``size``^3 voxels, counted by hand from the
    plain version's arithmetic (volume/noise.py, volume/bake.py) as uint32
    and fp32 operations; the int64 masks and widenings that emulate
    uint32 there are left out.  Per octave and voxel, D = ``dim`` axes,
    2^D corners:
      fp32:     per axis p * freq, p - floor, f - 1 and fade's 7: 10D; per
                corner the D gradients' scale and offset 2D, the dot
                product's D products and D - 1 sums; 2^D - 1 lerps of 3;
                the fBm's product and sum 2;
      convert:  per axis floor and float -> int 2D; per corner the D
                gradients' int -> float;
      imul:     per axis the lattice words' two products 2D; per corner D
                mixes of 2 products;
      int:      per axis i + 1; per corner D xors of the axis words and
                the seed word, D - 1 xors of the corner word with a
                constant, D mixes of 6 (3 shifts, 3 xors).
    Per voxel besides: fp32 12 (xyz + offset 3, the fBm's divide 1, the
    carving 8: scale, add, scale, add, subtract, clamp, divide, clamp),
    convert 1 (the bf16 round).  The lattice, r2 and the entries' offsets
    and time phases are per V^3 or per entry: left out.  Bytes: the bf16
    bank stored once; nothing is read."""
    corners = 2 ** dim
    per_octave = {
        "fp32": 10 * dim + corners * (4 * dim - 1) + 3 * (corners - 1) + 2,
        "convert": 2 * dim + corners * dim,
        "imul": 2 * dim + corners * 2 * dim,
        "int": dim + corners * (8 * dim - 1)}
    per_voxel = {"fp32": 12, "convert": 1, "imul": 0, "int": 0}
    vox = n * size ** 3
    ops = {k: (v * octaves + per_voxel[k]) * vox
           for k, v in per_octave.items()}
    return dict(ops, bytes=2 * vox)


def noise_bake_bound(work: dict) -> dict:
    """ms by term for ``noise_bake_work``'s counts: each operation an issue
    slot; fp32 and the int32 multiplies sharing the FMA pipe; int32 adds,
    shifts and logic; conversions; bytes at HBM's rate."""
    def ms(ops, per_sm):
        return ops / (per_sm * SM_CLOCKS_PER_S) * 1e3

    everything = sum(v for k, v in work.items() if k != "bytes")
    return {"issue": ms(everything, ISSUE_PER_SM),
            "fma pipe": max(ms(work["fp32"] + work["imul"], FP32_PER_SM),
                            ms(work["imul"], IMUL_PER_SM)),
            "int32 alu": ms(work["int"], INT32_PER_SM),
            "conversions": ms(work["convert"], CONVERT_PER_SM),
            "bytes": work["bytes"] / HBM_BYTES_PER_S * 1e3}


def noise_bake_sass(octaves: int) -> dict:
    """The 4-D kernel's SASS (``volq_torch.sass``): its instructions, those
    on its control-flow cycle (the octave loop), and -- when it has one
    cycle -- the instructions a thread issues, those outside the cycle
    once and the cycle's ``octaves`` times (code a branch skips counted
    too)."""
    from volq_torch import sass
    recs = sass.analyse("noise_bake", "noise_bake_kernel<4>")
    assert len(recs) == 1, [r["function"] for r in recs]
    r = recs[0]
    cyc = [c["insns"] for c in r["cycles"]]
    per_thread = r["insns"] - cyc[0] + octaves * cyc[0] \
        if len(cyc) == 1 else None
    return {"insns": r["insns"], "cycles": cyc, "per_thread": per_thread,
            "classes": r["classes"],
            "registers": r["resources"].get("REG"),
            "local_bytes": r["resources"].get("LOCAL")}


def check_noise_bake(cfg, t, card) -> dict:
    """The noise kernel on ``cfg``'s animated bank at simulation time
    ``t`` (a 0-d fp32 card tensor): one launch, bit-equal to the plain
    version on the card, timed alone (events over launches, and a
    CUDA-graph replay), the plain version timed, the bound of
    ``noise_bake_work``, and the issue time of the instructions its SASS
    holds (``noise_bake_sass``) beside it."""
    import torch
    from volq_torch.volume import bake as VB
    v = cfg.volume

    def kernel():
        return VB.bake_bank_4d(v.bank_size, v.size, v.seed, t,
                               octaves=v.octaves, noise_scale=v.noise_scale,
                               time_scale=v.time_scale, cutoff=v.cutoff,
                               edge=v.edge)

    def plain():
        return VB._bake_plain(v.bank_size, v.size, v.seed,
                              VB._noise_4d(t, v.seed, v.octaves,
                                           v.time_scale),
                              v.noise_scale, v.cutoff, v.edge,
                              torch.bfloat16, t.device)

    n0 = _counts()["noise_bake"]
    got = kernel()
    launches = _counts()["noise_bake"] - n0
    differ = int((got.view(torch.int16) != plain().view(torch.int16)).sum())
    assert launches == 1 and differ == 0, \
        f"noise_bake: {launches} launches, {differ} voxels differ"
    ms, device_ms = _cuda_ms(kernel, 50), _graph_ms(kernel)
    plain_ms = _cuda_ms(plain, 3)
    work = noise_bake_work(v.bank_size, v.size, v.octaves, 4)
    terms = noise_bake_bound(work)
    by = max(terms, key=terms.get)
    vox = v.bank_size * v.size ** 3
    per_voxel = {k: w / vox for k, w in work.items()}
    code = noise_bake_sass(v.octaves)
    sass_ms = None if code["per_thread"] is None else \
        code["per_thread"] * vox / (ISSUE_PER_SM * SM_CLOCKS_PER_S) * 1e3
    print(f"[timing] c5 noise_bake {tuple(got.shape)} bf16, bit-equal to "
          f"the plain version: kernel {ms:.4f} ms (device {device_ms:.4f} "
          f"ms), plain {plain_ms:.3f} ms, bound {terms[by]:.4f} ms ({by}; "
          f"terms { {k: round(x, 4) for k, x in terms.items()} }; a voxel "
          f"{ {k: round(x) for k, x in per_voxel.items()} }); SASS "
          f"{code['insns']} instructions, cycles {code['cycles']}, "
          f"{code['per_thread']} issued a thread -> {sass_ms} ms at one "
          f"a slot, {code['registers']} registers, local "
          f"{code['local_bytes']} B  [{card}]")
    return {"max_abs_err": 0.0, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": terms[by], "bound_by": by,
            "bound_terms_ms": terms, "ops_per_voxel": per_voxel,
            "sass": code, "sass_issue_ms": sass_ms}


def sim_step_work(n: int, alive: int, spawned: int) -> dict:
    """Operations by the pipe that executes them, and bytes, of one sim
    step of ``n`` slots, ``alive`` of them advected and ``spawned``
    drawing fresh attributes, counted by hand from the plain version's
    arithmetic (sim/prng.py, emit.py, forces.py, volume/noise.py) as
    uint32, fp32 and fp64 operations; the int64 masks and widenings that
    emulate uint32 there are left out.
      every slot: the age's add and the death test (fp32 2) in each of
                the three kernels; the emission rank's add (int 1);
      an alive slot: 12 perlin3 evaluations (2 points x 2 axes x 3
                potentials), each: per axis the potential's scale,
                offset and time add, p - floor, f - 1 and fade's 7 (fp32
                12), floor and float -> int (convert 2), the lattice
                words' two products (imul 2), i + 1 (int 1); per corner
                (8) the 3 gradients' scale and offset and the dot
                product's 3 products and 2 sums (fp32 11), 3 int -> float
                (convert 3), 3 mixes of 2 products (imul 6), 3 xors of the
                axis words and the seed word, 2 xors with a constant and 3
                mixes of 6 (int 23); 7 lerps of 3 (fp32 21); besides the
                points' 36 adds, 6 differences and 6 divisions, the time
                term, the curl's 3 differences, drag and curl's 12,
                the advection's 12 (fp32 76);
      a spawning slot: 25 threefry blocks (the frame's and the slot's
                fold_in, split(7), 12 draws, randint's split(2) and 2
                draws), each 2 xors of the key schedule, 2 adds, 20 rounds
                of add, rotate (2 shifts, or) and xor, 5 key injections of
                3 adds (int 119), and 14 xors of the two words; 12
                uniforms of shift and or (int 2), the - 1 and the floor
                (fp32 2), to double and back (convert 2) and the
                multiply-add in double (fp64 2); 6 erfinvs of x * x,
                negations, log1pf (about 12), the branch's sub or sqrtf,
                the product (fp32 18) and 8 steps in double (fp64 16,
                convert 16); the direction's norm, clamp, 3 divisions,
                powf (about 12), the position's, velocity's and albedo's
                products and sums (fp32 40); randint's 3 modulos and a
                product and sum (int 5, imul 1).
    Bytes: the state's 52 bytes a slot read once and written once."""
    per_alive = {"fp32": 12 * (3 * 12 + 8 * 11 + 21) + 76,
                 "convert": 12 * (3 * 2 + 8 * 3),
                 "imul": 12 * (3 * 2 + 8 * 6),
                 "int": 12 * (3 * 1 + 8 * 23), "fp64": 0}
    per_spawn = {"fp32": 12 * 2 + 6 * 18 + 40,
                 "convert": 12 * 2 + 6 * 16, "imul": 1,
                 "int": 25 * 119 + 14 + 12 * 2 + 5,
                 "fp64": 12 * 2 + 6 * 16}
    per_slot = {"fp32": 3 * 2, "convert": 0, "imul": 0, "int": 1,
                "fp64": 0}
    ops = {k: per_slot[k] * n + per_alive[k] * alive
           + per_spawn[k] * spawned for k in per_slot}
    return dict(ops, bytes=2 * 52 * n)


def sim_step_bound(work: dict) -> dict:
    """ms by term for ``sim_step_work``'s counts: ``noise_bake_bound``'s
    terms, the fp64 operations added to the issue slots, and the fp64
    pipe."""
    terms = noise_bake_bound({k: v for k, v in work.items() if k != "fp64"})
    terms["issue"] += work["fp64"] / (ISSUE_PER_SM * SM_CLOCKS_PER_S) * 1e3
    terms["fp64 pipe"] = work["fp64"] / (FP64_PER_SM * SM_CLOCKS_PER_S) * 1e3
    return terms


def check_sim_kernel(cfg, card, n_frames: int = N_FRAMES_C5) -> dict:
    """The sim's kernels on ``cfg``'s particles, its ages drawn at 0.95 to
    1.01 of the lifetimes so that slots die and respawn every step:
    ``n_frames`` steps by the kernels and by the plain version on the
    card, bit-equal after each (every attribute, frame, carry, time),
    SIM_LAUNCHES launches a step; then a step timed: by events over
    launches, replayed from a CUDA graph (the kernels' own time), on the
    host clock between synchronizations (with the wrapper's host work),
    the plain version by events; and the bound of ``sim_step_work``."""
    import torch
    from volq_torch.scene.state import init_scene
    from volq_torch.sim.step import _sim_step_plain, sim_step
    cfg = dataclasses.replace(cfg, init_age_frac=(0.95, 1.01))
    state = init_scene(cfg)
    k = p = state
    spawned = []
    for i in range(n_frames):
        n0 = _counts()["sim_step"]
        k = sim_step(k, cfg)
        launches = _counts()["sim_step"] - n0
        p = _sim_step_plain(p, cfg)
        differ = sum(int((a.view(torch.int32) if a.is_floating_point()
                          else a).ne(b.view(torch.int32)
                                     if b.is_floating_point() else b).sum())
                     for a, b in zip((*k.particles, k.frame, k.spawn_carry,
                                      k.time),
                                     (*p.particles, p.frame, p.spawn_carry,
                                      p.time)))
        assert launches == SIM_LAUNCHES and differ == 0, \
            f"sim step {i}: {launches} launches, {differ} words differ"
        spawned.append(int(k.particles.age.eq(0).sum()))
    n = k.particles.age.shape[0]
    alive = int((k.particles.age + torch.tensor(cfg.dt, device="cuda")
                 < k.particles.lifetime).sum())
    ms, device_ms = _cuda_ms(lambda: sim_step(k, cfg), 50), \
        _graph_ms(lambda: sim_step(k, cfg))
    wall_ms = _wall_ms(lambda: sim_step(k, cfg), 50)
    plain_ms = _cuda_ms(lambda: _sim_step_plain(k, cfg), 5)
    work = sim_step_work(n, alive, round(sum(spawned) / n_frames))
    terms = sim_step_bound(work)
    by = max(terms, key=terms.get)
    print(f"[timing] c5 sim_step, {n} slots ({alive} alive, spawned a step "
          f"{spawned}), {n_frames} steps bit-equal to the plain version, "
          f"{SIM_LAUNCHES} launches a step: kernels {ms:.4f} ms (device "
          f"{device_ms:.4f} ms, host clock {wall_ms:.4f} ms), plain "
          f"{plain_ms:.3f} ms, bound {terms[by]:.4f} ms ({by}; terms "
          f"{ {k_: round(x, 5) for k_, x in terms.items()} }; work "
          f"{work})  [{card}]")
    return {"max_abs_err": 0.0, "ms": ms, "device_ms": device_ms,
            "wall_ms": wall_ms, "plain_ms": plain_ms,
            "launches_per_step": SIM_LAUNCHES, "spawned": spawned,
            "alive": alive, "bound_ms": terms[by], "bound_by": by,
            "bound_terms_ms": terms, "work": work}


def light_bake_work(n: int, size: int, itemsize: int) -> dict:
    """Operations, bytes and the chain of the light sweep of ``n`` entries
    of ``size``^3 voxels stored ``itemsize`` bytes each, counted by hand
    from the plain version (volume/lightbake.py).  Each of the V - 1
    steps after the entry slice, per voxel of its plane: two bilinear
    shifts of 3 lerps (sub, mul, add) each, and the trapezoid's add, two
    multiplies and the add to the carried depth: 22 fp32 operations; the
    constants (per entry) are left out.  Bytes: the bank read once, the
    fp32 depth written once.  The chain: the V - 1 steps, each a carried
    voxel's 7 dependent fp32 operations (its shift's two lerps and the
    add), without the shared-memory round trip and the block's barrier
    between steps."""
    steps = size - 1
    return {"fp32": 22 * n * size * size * steps,
            "bytes": n * size ** 3 * (itemsize + 4),
            "chain_steps": steps, "chain_ops": 7 * steps}


def light_bake_bound(work: dict, fadd_clocks: float = 4.0) -> dict:
    """ms by term for ``light_bake_work``'s counts: bytes at HBM's rate,
    fp32 operations at the card's rate, and the chain's dependent
    operations at ``fadd_clocks`` each (the fp32 add's latency probe_stage
    times on the card, ~4 clocks) at the 1980-MHz clock."""
    return {"bytes": work["bytes"] / HBM_BYTES_PER_S * 1e3,
            "operations": work["fp32"] / FP32_FLOP_PER_S * 1e3,
            "chain": work["chain_ops"] * fadd_clocks
            / (SM_CLOCKS_PER_S / 132) * 1e3}


def check_light_kernel(cfg, volumes, light, card) -> dict:
    """The light kernel on ``volumes`` (``cfg``'s bank on the card) toward
    ``light``: one launch, bit-equal to the plain sweep on the card (every
    fp32 word), timed alone (events over launches, and a CUDA-graph
    replay), the plain sweep timed, and the bound of ``light_bake_work``."""
    import torch
    from volq_torch.volume import lightbake as LB
    axis = LB.dominant_axis(cfg.light.direction)

    def kernel():
        return LB.bake_light_volumes(volumes, light.direction, axis)

    def plain():
        return LB._bake_light_plain(volumes, light.direction, axis)

    n0 = _counts()["light_bake"]
    got = kernel()
    launches = _counts()["light_bake"] - n0
    differ = int((got.view(torch.int32) != plain().view(torch.int32)).sum())
    assert launches == 1 and differ == 0, \
        f"light_bake: {launches} launches, {differ} voxels differ"
    ms, device_ms = _cuda_ms(kernel, 50), _graph_ms(kernel)
    plain_ms = _cuda_ms(plain, 5)
    n, size = volumes.shape[0], volumes.shape[-1]
    work = light_bake_work(n, size, volumes.element_size())
    terms = light_bake_bound(work)
    by = max(terms, key=terms.get)
    print(f"[timing] c5 light_bake {tuple(got.shape)} from "
          f"{volumes.dtype}, axis {axis}, bit-equal to the plain sweep, 1 "
          f"launch: kernel {ms:.4f} ms (device {device_ms:.4f} ms), plain "
          f"{plain_ms:.3f} ms, bound {terms[by]:.4f} ms ({by}; terms "
          f"{ {k: round(x, 5) for k, x in terms.items()} }; work {work})  "
          f"[{card}]")
    return {"max_abs_err": 0.0, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": terms[by], "bound_by": by,
            "bound_terms_ms": terms, "work": work}


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


def _cells_met(box, valid, Hc: int, Wc: int) -> int:
    """Canvas cells inside at least one valid particle's box (clipped to
    the [Hc, Wc] canvas): a 2-D difference array of the boxes, summed."""
    import torch
    b = box[valid > 0].long()
    y0, y1 = b[:, 0].clamp(0, Hc), b[:, 1].clamp(0, Hc)
    x0, x1 = b[:, 2].clamp(0, Wc), b[:, 3].clamp(0, Wc)
    ok = (y1 > y0) & (x1 > x0)
    y0, y1, x0, x1 = y0[ok], y1[ok], x0[ok], x1[ok]
    d = torch.zeros((Hc + 1) * (Wc + 1), dtype=torch.int64, device=b.device)
    one = torch.ones_like(y0)
    for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        d.index_add_(0, yy * (Wc + 1) + xx, sign * one)
    cover = d.view(Hc + 1, Wc + 1).cumsum(0).cumsum(1)[:Hc, :Wc]
    return int((cover > 0).sum())


def _sub_tile_visits(box, valid, Hc: int, Wc: int) -> int:
    """Warp sub-tiles (4 x 32 cells, B's unit of work) that the valid
    particles' boxes meet, summed over the particles: the placements B's
    warps run."""
    b = box[valid > 0].long()
    y0, y1 = b[:, 0].clamp(0, Hc), b[:, 1].clamp(0, Hc)
    x0, x1 = b[:, 2].clamp(0, Wc), b[:, 3].clamp(0, Wc)
    ok = (y1 > y0) & (x1 > x0)
    ny = _floor_div(y1 - 1, 4) - _floor_div(y0, 4) + 1
    nx = _floor_div(x1 - 1, 32) - _floor_div(x0, 32) + 1
    return int((ny * nx)[ok].sum())


def _floor_div(a, d):
    import torch
    return torch.div(a, d, rounding_mode="floor")


def _sm_clock_during(fn, ms_each: float) -> int:
    """The card's SM clock (MHz, as nvidia-smi reads it) while ~1.5 s of
    ``fn``'s launches are queued on it."""
    import torch
    torch.cuda.synchronize()
    for _ in range(max(20, int(1500 / max(ms_each, 1e-3)))):
        fn()
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60,
        check=True).stdout.split()[0]
    torch.cuda.synchronize()
    return int(mhz)


def bounds(march, comp, canvas):
    """Least time the card needs for kernels A and B on these inputs:
    max(bytes moved / HBM rate, flops / fp32 rate), in ms.  B's bytes
    count the canvas cells some valid box meets (read and written: the
    others are not the function's to touch), the valid particles' planes
    and the per-particle scalars; its flops the canvas cells inside the
    valid particles' boxes (~30 per cell and plane pair unlit, 52 lit,
    44 / 76 with the interleaved association's four folded channels)."""
    mp, cp = march[6], comp[5]
    npl = 2 if mp.lit else 1
    a_in, a_flops, nv = _march_work(march)
    a_bytes = a_in + mp.N * npl * mp.RM * mp.RM * 4
    met = _cells_met(comp[2], comp[4], cp.Hc, cp.Wc)
    b_bytes = (2 * met * canvas.shape[0] * canvas.element_size()
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
    C and read by D dominate; D also moves the canvas cells some image of
    the chunk covers in and out (the others are not the function's to
    touch)."""
    from volq_torch.render import kernel as K
    c_by = c_fl = d_by = d_fl = 0
    for img_args, comp_args in chunks:
        oy, ox, order, cp = comp_args
        rects = K._chunk_rects(oy, ox, order, cp.RP)
        met = _cells_met(rects, rects[:, 0] * 0 + 1, cp.Hc, cp.Wc)
        mp = img_args[6]
        npl = 2 if mp.lit else 1
        m_in, m_fl, nv = _march_work(img_args)
        img_bytes = mp.N * 4 * mp.RP * mp.RP * itemsize
        c_by += m_in + mp.N * 12 + img_bytes
        c_fl += m_fl + nv * (npl * 4 * (mp.RP * mp.RM + mp.RP * mp.RP)
                             + 13 * mp.RP * mp.RP)
        d_by += (img_bytes + 2 * met * 4 * canvas.element_size()
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


def drive(tag, state, camera, light, cfg, lv, sb, n, expect,
          no_copies=False):
    """frames(n) from zeroed launch counters; the counts of the warp
    kernels, the noise kernel and the light kernel must equal ``expect``
    (per frame; 0 where absent: a static bank and its light bank are
    baked at set-up) times n, the sim kernels' SIM_LAUNCHES times n.
    ``no_copies``: the frames run under the profiler's CPU tracing (the
    program's counters count) and must make no blocking copy (``h2d`` +
    ``d2h`` 0) and no new constant (``const_miss`` 0).  Returns (state,
    image, counts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from volq_torch import _build
    from volq_torch.core import trace
    from volq_torch.engine import loop
    _build.launches.clear()
    trace.reset()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) if no_copies \
            else contextlib.nullcontext():
        state, image, stats = loop.frames(state, camera, light, cfg, lv, sb,
                                          n=n)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counts()
    if no_copies:
        got = {}
        for (_, k), v in trace.counters().items():
            got[k] = got.get(k, 0) + v
        copies = got.get("h2d", 0) + got.get("d2h", 0)
        print(f"[main] {tag} {n} frames: h2d + d2h {copies}, const_miss "
              f"{got.get('const_miss', 0)}, const_hit "
              f"{got.get('const_hit', 0)}")
        assert copies == 0 and not got.get("const_miss"), \
            f"{tag}: {copies} blocking copies, " \
            f"{got.get('const_miss', 0)} new constants in {n} frames"
    print(f"[main] {tag} frames(n={n}) in {dt:.3f} s, launches {counts}, "
          f"stats of the last frame "
          f"{ {k: int(v[-1]) for k, v in stats.items()} }")
    for name in NAMES + ("noise_bake", "sim_step", "light_bake"):
        want = dict(expect, sim_step=SIM_LAUNCHES).get(name, 0) * n
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


def sweep_plans(tag, march, Pm, card):
    """A at launch plans beside the planned one, on the same inputs (each
    output must equal the planned launch's): a ring of two stages, and
    the widest blocks the march rect allows.  Returns {plan: ms}."""
    import torch
    from volq_torch.render import kernel as K
    mp = march[6]
    it = march[0].element_size()
    plan = K.march_plan(mp, it)
    wide = K.MARCH_BLOCK // mp.RM
    out = {}
    for G, D in ((plan.G, 2), (wide, plan.stages)):
        alt = K.MarchPlan(G=G, stages=D, smem=K.march_smem(mp, D, it))
        P2, _ = K.warp_march(*march, plan=alt)
        assert torch.equal(P2, Pm), f"{tag}: warp_march {alt.arm} G={G}"
        key = f"{mp.RM * G} threads, {alt.arm}"
        out[key] = _cuda_ms(lambda: K.warp_march(*march, plan=alt), 10)
    print(f"[sweep] {tag} warp_march: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())
          + f" (equal to the planned launch)  [{card}]")
    return out


def _wrapper_ms(fn, reps: int = 5) -> float:
    """Median of the CUDA-event ms around one call of ``fn``, waited on
    each time (after one warm-up call): the launch and the host work of
    the Python wrapper before it."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return sorted(ts)[len(ts) // 2]


def _graph_ms(fn, reps: int = 20) -> float:
    """Device ms per call of ``fn`` replayed from a CUDA graph: the
    kernels' own time, without the Python wrapper's."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # relaxed: kernel A's launch sets its shared-memory attribute
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    t = _cuda_ms(graph.replay, reps)
    del graph
    return t


def time_fused(tag, state, camera, light, cfg, sb, card, errs,
               sweep=False):
    """ms of A, B and their plain versions at the state's inputs, and
    their bounds.  ``sb`` None (animated scenes): the state's banks are
    baked here, as the frame does.  B's plain version walks every particle
    of the frame once: that one walk is timed and its canvas must equal
    the kernel's.  ``sweep``: also sweep_plans."""
    import torch
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
    blank = K.canvas_init(cfg, H, Pm.device)
    canvas = blank.clone()      # B updates it in place, launch after launch
    ms = {"warp_march": _cuda_ms(lambda: K.warp_march(*march), 20),
          "warp_composite": _cuda_ms(
              lambda: K.warp_composite(canvas, Pm, *comp), 20)}
    walked = []
    plain = {"warp_march": _cuda_ms(lambda: K.warp_march_plain(*march), 3),
             "warp_composite": _cuda_ms(
                 lambda: walked.append(K.warp_composite_plain(
                     blank.clone(), Pm, *comp)), 1, warm=False)}
    out_k = K.warp_composite(blank.clone(), Pm, *comp)
    d = float((out_k.float() - walked[0].float()).abs().max())
    touched = float((out_k.float() - blank.float()).abs().max())
    print(f"[kernels] {tag} warp_composite {_mode(cfg)} N={comp[5].N} at the "
          f"timed inputs: bit-equal {torch.equal(out_k, walked[0])}, max "
          f"diff {d:.3e}, max change vs blank canvas {touched:.4f}")
    assert torch.equal(out_k, walked[0]), f"warp_composite {tag} differs"
    assert touched > 0.0, "warp_composite left the canvas blank"
    errs["warp_composite"] = max(errs["warp_composite"], d)
    swept = sweep_plans(tag, march, Pm, card) if sweep else None
    del walked, out_k, blank
    bnd = bounds(march, comp, canvas)
    mp, cp = march[6], comp[5]
    plan = K.march_plan(mp, march[0].element_size())
    bplan = K.composite_plan(cp)
    # device times (replayed from CUDA graphs): B's fill kernel alone, and
    # A and B as launched (the ms above also hold the wrappers' host time
    # where that is the longer)
    fill_ms = _graph_ms(lambda: K.tile_fill(comp[2], comp[4], cp))
    mhz = _sm_clock_during(lambda: K.warp_march(*march), ms["warp_march"])
    visits = _sub_tile_visits(comp[2], comp[4], cp.Hc, cp.Wc)
    dev_ms = {"warp_march": _graph_ms(lambda: K.warp_march(*march)),
              "warp_composite": _graph_ms(
                  lambda: K.warp_composite(canvas, Pm, *comp))}
    extra = {"warp_march": {"arm": plan.arm, "stages": plan.stages,
                            "threads": mp.RM * plan.G, "sm_mhz": mhz},
             "warp_composite": {"fill_ms": fill_ms, "list_slots": bplan.capt,
                                "sub_tile_visits": visits}}
    if swept:
        extra["warp_march"]["sweep_ms"] = swept
    prev = PREV_MS.get(tag, {})
    notes = {"warp_march": f"arm {plan.arm} (ring depth {plan.stages}), "
                           f"{mp.RM * plan.G} threads a block, SM clock "
                           f"under A's launches {mhz} MHz",
             "warp_composite": f"{bplan.ntx} x {bplan.nty} tiles, "
                               f"{bplan.capt} list slots a tile, "
                               f"{visits} warp sub-tile placements, the "
                               f"lists' fill alone {fill_ms:.4f} ms"}
    for name in ms:
        print(f"[timing] {tag} {name}: kernel {ms[name]:.4f} ms"
              f"{_was(prev, name)} "
              f"(device {dev_ms[name]:.4f} ms), plain {plain[name]:.3f} "
              f"ms, bound {bnd[name][0]:.4f} ms ({bnd[name][1]}); "
              f"{notes[name]}  [{card}]")
    return {name: {"ms": ms[name],
                   "device_ms": dev_ms[name], "plain_ms": plain[name],
                   "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
                   **extra[name]}
            for name in ms}


def _was(prev, name):
    """The [timing] lines' note of a kernel's reading in the last run
    before C's and D's redesign (PREV_MS)."""
    if name not in prev:
        return ""
    return (f", before C's and D's redesign {prev[name]:.4f} ms (a prior "
            f"run's reading, not this run's)")


def sweep_images(tag, img_args, images, card):
    """C at launch plans beside the planned one, on the same inputs (each
    output must equal the planned launch's): a ring of two stages, and
    the widest blocks the march rect allows.  Returns {plan: ms}."""
    import torch
    from volq_torch.render import kernel as K
    mp = img_args[6]
    it = img_args[0].element_size()
    plan = K.images_plan(mp, it)
    wide = K.MARCH_BLOCK // mp.RM
    out = {}
    for G, D in ((plan.G, 2), (wide, plan.stages)):
        alt = K.MarchPlan(G=G, stages=D, band=plan.band,
                          smem=K.images_smem(mp, D, it, plan.band))
        got, _ = K.warp_images(*img_args, plan=alt)
        assert torch.equal(got, images), f"{tag}: warp_images {alt.arm} G={G}"
        key = f"{mp.RM * G} threads, {alt.arm}"
        out[key] = _cuda_ms(lambda: K.warp_images(*img_args, plan=alt), 10)
    print(f"[sweep] {tag} warp_images: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())
          + f" (equal to the planned launch)  [{card}]")
    return out


def time_unfused(tag, state, camera, light, cfg, sb, card, sweep=False):
    """ms per launch of C, D and their plain versions (the mean over the
    frame's megachunks), their device time replayed from CUDA graphs, and
    their bounds; C's plan and the SM clock under its launches, D's fill
    alone, list slots and longest list.  ``sweep``: also sweep_images (on
    the first megachunk)."""
    import torch
    from volq_torch.render import kernel as K
    from volq_torch.render.warp import unfused_inputs
    H = cfg.render.height
    chunks, _ = unfused_inputs(state.particles, camera, light, cfg, sb[0],
                               0, H, sb[1])
    canvas = K.canvas_init(cfg, H, sb[0].device, fused=False)
    n = len(chunks)
    names = ("warp_images", "composite_chunk")
    ms = dict.fromkeys(names, 0.0)
    plain, dev_ms = dict(ms), dict(ms)
    fill_ms, longest, visits, swept = 0.0, 0, 0, None
    for img_args, comp_args in chunks:
        images, _ = K.warp_images(*img_args)
        if sweep and swept is None:
            swept = sweep_images(tag, img_args, images, card)
        ms["warp_images"] += _cuda_ms(
            lambda: K.warp_images(*img_args), 10) / n
        ms["composite_chunk"] += _cuda_ms(
            lambda: K.composite_chunk(canvas, images, *comp_args), 10) / n
        dev_ms["warp_images"] += _graph_ms(
            lambda: K.warp_images(*img_args)) / n
        dev_ms["composite_chunk"] += _graph_ms(
            lambda: K.composite_chunk(canvas, images, *comp_args)) / n
        fill_ms += _graph_ms(lambda: K.chunk_fill(*comp_args)) / n
        longest = max(longest, int(K.chunk_fill(*comp_args)[0].max()))
        rects = K._chunk_rects(*comp_args[:3], comp_args[3].RP)
        visits += _sub_tile_visits(rects, rects[:, 0] * 0 + 1,
                                   comp_args[3].Hc, comp_args[3].Wc)
        plain["warp_images"] += _cuda_ms(
            lambda: K.warp_images_plain(*img_args), 2) / n
        plain["composite_chunk"] += _cuda_ms(
            lambda: K.composite_chunk_plain(canvas, images, *comp_args),
            1, warm=False) / n
    img_args, comp_args = chunks[0]
    mp, it = img_args[6], img_args[0].element_size()
    plan, dplan = K.images_plan(mp, it), K.chunk_plan(comp_args[3])
    mhz = {"warp_images": _sm_clock_during(lambda: K.warp_images(*img_args),
                                           ms["warp_images"]),
           "composite_chunk": _sm_clock_during(
               lambda: K.composite_chunk(canvas, images, *comp_args),
               ms["composite_chunk"])}
    extra = {"warp_images": {"arm": plan.arm, "stages": plan.stages,
                             "threads": mp.RM * plan.G, "band": plan.band,
                             "smem": plan.smem},
             "composite_chunk": {"fill_ms": fill_ms,
                                 "list_slots": dplan.capt,
                                 "longest_list": longest,
                                 "sub_tile_visits": visits // n}}
    if swept:
        extra["warp_images"]["sweep_ms"] = swept
    notes = {"warp_images": f"arm {plan.arm} (ring depth {plan.stages}), "
                            f"{mp.RM * plan.G} threads a block, y-pass band "
                            f"{plan.band} rows, {plan.smem} B shared",
             "composite_chunk": f"{dplan.ntx} x {dplan.nty} tiles, "
                                f"{dplan.capt} list slots a tile, longest "
                                f"list {longest}, {visits // n} warp "
                                f"sub-tile visits a launch, the lists' fill "
                                f"alone {fill_ms:.4f} ms"}
    bnd = bounds_unfused(chunks, canvas, sb[0].element_size())
    prev = PREV_MS.get(tag, {})
    for name in ms:
        extra[name]["sm_mhz"] = mhz[name]
        print(f"[timing] {tag} {name} (per launch, {n} per frame): kernel "
              f"{ms[name]:.4f} ms{_was(prev, name)} (device "
              f"{dev_ms[name]:.4f} ms), plain {plain[name]:.3f} ms, bound "
              f"{bnd[name][0]:.4f} ms ({bnd[name][1]}); {notes[name]}, SM "
              f"clock under its launches {mhz[name]} MHz  [{card}]")
    return {name: {"ms": ms[name], "device_ms": dev_ms[name],
                   "plain_ms": plain[name], "bound_ms": bnd[name][0],
                   "bound_by": bnd[name][1], **extra[name]}
            for name in ms}


def time_loop(tag, prepared, cfg, card, fb=N_FRAMES, n_frames=16, warmup=1,
              mesh=0):
    """ms/frame of engine.loop.time_frames (printed and returned): on the
    ``prepared`` state, or (``mesh`` > 0) the sharded loop on that many
    ranks, each setting ``cfg`` up itself."""
    from volq_torch.engine import loop
    band = []
    spf, _ = loop.time_frames(cfg, n_frames, warmup=warmup, fb=fb, windows=3,
                              window_times=band, prepared=prepared,
                              mesh=mesh)
    mrays = cfg.render.width * cfg.render.height / spf / 1e6
    print(f"[loop] {tag} time_frames: {spf * 1e3:.3f} ms/frame, "
          f"{mrays:.2f} Mrays/s (windows "
          f"{[round(w * 1e3, 3) for w in band]} ms/frame)  [{card}]")
    return spf * 1e3


def check_probes(errs):
    """The three probe kernels against their plain versions, both arms of
    probe_mma and probe_stage.  ``errs[name]`` gets the new arm's error,
    ``errs[name, arm]`` each arm's."""
    import torch
    from volq_torch import probe
    from volq_torch.probe import tensor_core, stage, window
    dev = "cuda"
    # every shape of the probes' sweep, so that every instantiation that
    # the sweep launches is held to the plain version, each at the stack
    # depth of its timed launches (so that the plan and the accumulators
    # in use are theirs), chained and round-robin, on 1 and 132 blocks
    shapes = {(M, K, N): t for t, M, K, N in
              tensor_core.SHAPES + tensor_core.PIPE_SHAPES}
    for (M, K, N), tag in shapes.items():
        R, _ = tensor_core.size_run(M, K, N)
        A, B = tensor_core.make_inputs(R, M, K, N, dev)
        ref1 = probe.mma_probe_plain(A, B, 4)
        scale = float(ref1.abs().max())
        for arm in tensor_core.ARMS:
            worst, plans = 0.0, set()
            for nacc in (1, 8):
                plan = tensor_core.plan_for(arm, R, M, K, N, nacc)
                plans.add(plan.nacc)
                for blocks in (1, tensor_core.N_SM):
                    out = probe.mma_probe(A, B, 4, nacc, blocks, arm)
                    assert tuple(out.shape) == (blocks, M, N)
                    worst = max(worst, float((out - ref1).abs().max()))
            rel = worst / scale
            how = "resident" if plan.resident else "KC %d" % plan.KC
            if arm == "wgmma":
                how += (f", {'transposed' if plan.trans else 'direct'} "
                        f"n{plan.n}, {plan.tpw} tiles a warpgroup, pad "
                        f"{plan.pad}, {plan.stages} stages")
            print(f"[kernels] probe_mma {arm} {tag} {M} x {K} x {N} R {R} "
                  f"G 4 nacc 1 / 8 (in use {sorted(plans)}) blocks 1 / "
                  f"{tensor_core.N_SM} {how}: max|kernel - plain| = "
                  f"{worst:.3e} = {rel:.3e} of max |out|")
            assert rel <= MMA_TOL, f"probe_mma {arm} {tag} disagrees: {rel}"
            for key, v in ((("probe_mma", arm), worst),
                           (("probe_mma_rel", arm), rel)):
                errs[key] = max(errs.get(key, 0.0), v)
    for K, small, const in ((1, 0, 0), (4, 0, 0), (12, 0, 0), (2, 3, 4)):
        args = stage.make_inputs(K, small, const, dev)
        runs = [("cp_async", None)] + [
            ("tma", d) for d in stage.DEPTHS
            if stage.ring_fits(K, small, const, d)]
        for arm, depth in runs:
            for G in (1, 2048):
                out = probe.stage_probe(*args, G, arm, depth)
                ref = probe.stage_probe_plain(*args, G)
                torch.cuda.synchronize()
                d = float((out - ref).abs().max())
                print(f"[kernels] probe_stage {arm} depth {depth or 2} K "
                      f"{K} small {small} const {const} G {G}: bit-equal "
                      f"{torch.equal(out, ref)}, max diff {d:.3e}, sum "
                      f"{float(out.sum()):.3f}")
                assert torch.equal(out, ref), f"probe_stage {arm} differs"
                assert float(out.sum()) > 0.0
                errs["probe_stage", arm] = max(
                    errs.get(("probe_stage", arm), 0.0), d)
    errs["probe_mma"] = errs["probe_mma", "wgmma"]
    errs["probe_stage"] = errs["probe_stage", "tma"]
    # probe_window: both arms at every alignment each takes, on the
    # reference's 4096 windows and on the heavy-overlap cases
    for align in window.ALIGNS["tma"]:
        cases = {"reference": window.make_offsets(align),
                 **window.overlap_cases(align, seed=align)}
        for case, o in cases.items():
            off = torch.from_numpy(o).to(dev)
            ref = probe.window_probe_plain(
                torch.zeros((window.H, window.W), device=dev), off, align)
            for arm in window.ARMS:
                if align not in window.ALIGNS[arm]:
                    continue
                out = probe.window_probe(
                    torch.zeros((window.H, window.W), device=dev), off,
                    align, arm=arm)
                torch.cuda.synchronize()
                d = float((out - ref).abs().max())
                print(f"[kernels] probe_window {arm} align {align} {case} N "
                      f"{window.N} canvas {window.H} x {window.W}: bit-equal "
                      f"{torch.equal(out, ref)}, max diff {d:.3e}, deepest "
                      f"overlap {int(out.max())}")
                assert torch.equal(out, ref), f"probe_window {arm} differs"
                assert float(out.sum()) == window.N * window.WH * window.WW
                errs["probe_window", arm] = max(
                    errs.get(("probe_window", arm), 0.0), d)
    errs["probe_window"] = errs["probe_window", "tma"]


def check_probe_sass():
    """The arms run what they claim: HGMMA and UTMALDG in every function
    of probe_mma's wgmma arm (HMMA in the mma_sync arm's), UBLKCP in
    probe_stage's tma arm and no block barrier (BAR) in its loops,
    UTMALDG and UTMASTG in probe_window's tma arm, LDGSTS in its cp_async
    arm and no BAR on any cycle of the control flow through either arm's
    walk."""
    from volq_torch import sass
    for name, arms in (("probe_mma", {"wgmma": ("HGMMA", "UTMALDG"),
                                      "probe_mma_kernel": ("HMMA",)}),
                       ("probe_stage", {"tma": ("UBLKCP", "SYNCS"),
                                        "probe_stage_kernel": ("LDGSTS",)}),
                       ("probe_window", {
                           "probe_window_tma_kernel": ("UTMALDG", "UTMASTG",
                                                       "SYNCS"),
                           "probe_window_kernel": ("LDGSTS",)})):
        recs = sass.analyse(name)
        for match, want in arms.items():
            fns = [r for r in recs if match in r["function"]]
            assert fns, f"no {match} function in {name}'s SASS"
            for r in fns:
                have = {op: r["opcodes"].get(op, 0) for op in want}
                assert all(have.values()), f"{r['function']}: {have}"
            print(f"[sass] {name} {match}: {len(fns)} functions, each with "
                  + ", ".join(want) + "; e.g. " + fns[0]["function"] + ": "
                  + " ".join(f"{k} {v}" for k, v in
                             fns[0]["classes"].items()))
        if name == "probe_stage":
            tma = [r for r in recs if "tma" in r["function"]][0]
            bars = [lp for lp in tma["loops"] if lp["opcodes"].get("BAR")]
            assert not bars, f"a block barrier in the tma arm's loops: {bars}"
            print(f"[sass] probe_stage tma: {len(tma['loops'])} loops, no "
                  f"BAR in any")
        if name == "probe_window":
            # a walk is the cycle of the control-flow graph that holds its
            # copies: every instruction that can run again after them.  The
            # scan's block barriers must lie on no such cycle (the reader's
            # backward-branch spans may enclose them: code laid out after
            # the exit jumps back)
            for match, ops in (("probe_window_kernel", ("LDGSTS", "STG")),
                               ("probe_window_tma_kernel",
                                ("UTMALDG", "UTMASTG")),
                               ("probe_window_tma_kernel", ("FADD", "SYNCS"))):
                for fn in (r for r in recs if match in r["function"]):
                    walks = [cy for cy in fn["cycles"]
                             if all(cy["opcodes"].get(o) for o in ops)]
                    fname = fn["function"].split("(")[0]
                    assert len(walks) == 1, f"{fname}: {len(walks)} walks"
                    assert not walks[0]["opcodes"].get("BAR"), \
                        f"a block barrier in {fname}'s walk: {walks[0]}"
                    bars = fn["opcodes"].get("BAR", 0)
                    print(f"[sass] {fname} walk with {' + '.join(ops)}: a "
                          f"cycle of {walks[0]['insns']} instructions, no "
                          f"BAR (the function's {bars} BARs lie on no cycle "
                          f"with it)")


def run_probes(card):
    """The probes' entry point, in process, from zeroed counters.  Returns
    (launch counts, records by probe)."""
    from volq_torch import _build
    from volq_torch.probe import __main__ as probe_main
    from volq_torch.probe import stage, tensor_core, window
    _build.launches.clear()
    recs = {name: probe_main.RUNNERS[name](card)
            for name in ("mma", "stage", "window")}
    counts = _counts()
    arms = {name: {arm: _build.launches[f]
                   for arm, f in zip(mod.ARMS, LAUNCHES[name])}
            for name, mod in (("probe_mma", tensor_core),
                              ("probe_stage", stage),
                              ("probe_window", window))}
    print(f"[main] probes: launches {counts}, by arm {arms}")
    for name in PROBES:
        assert counts[name] > 0, f"{name} never launched in the probes' run"
    for name, by_arm in arms.items():
        assert all(by_arm.values()), f"an arm of {name} never launched"
    top = max(r["tflops"] for r in recs["mma"])
    print(f"[main] probes: highest tensor-core rate read {top:.2f} TFLOP/s "
          f"(the card's dense bf16 peak is {BF16_FLOP_PER_S / 1e12:.0f})")
    assert top <= BF16_FLOP_PER_S / 1e12, "a rate above the card's peak"
    assert all(r["ns_per_step"] > 0 for r in recs["stage"])
    assert all(r["ns_per_window"] > 0 for r in recs["window"])
    # the copy engine's own answer at 16 bytes must be yes (the check's
    # control); at 8 and 4 bytes it is what the card says
    boxes = {r["align"]: r["box"] for r in recs["window"] if r["box"]}
    print(f"[main] probes: an [8, 128] TMA box at x = align elements: "
          f"{boxes}")
    assert boxes[4] == "taken", boxes
    return counts, arms, recs


def time_probes(card):
    """One named point per probe: the kernel's ms (the new arm's -- wgmma,
    tma -- with the old arm's beside it), its plain version's, the bound,
    and the library's call of the same function: for probe_mma one
    torch.matmul of the same sums, for probe_window the fastest of three
    accumulating index calls."""
    import torch
    from volq_torch import probe
    from volq_torch.probe import tensor_core, stage, window
    dev = "cuda"
    out = {}
    # probe_mma: c3_dot1 (80 x 128 x 64), round-robin, one block per SM
    M, K, N = 80, 128, 64
    blocks = tensor_core.N_SM
    R, G = tensor_core.size_run(M, K, N)
    A, B = tensor_core.make_inputs(R, M, K, N, dev)
    dots = blocks * G * R
    by = A.numel() * 2 + B.numel() * 2 + blocks * M * N * 4
    t_b, t_f = by / HBM_BYTES_PER_S, 2.0 * M * K * N * dots / BF16_FLOP_PER_S
    ms = {arm: probe.median_ms(
        lambda: probe.mma_probe(A, B, G, 8, blocks, arm))
        for arm in tensor_core.ARMS}
    plan = tensor_core.wgmma_plan(R, M, K, N, 8)
    out["probe_mma"] = {
        "ms": ms["wgmma"], "arm": "wgmma", "mma_sync_ms": ms["mma_sync"],
        "plain_ms": _cuda_ms(lambda: probe.mma_probe_plain(A, B, G, blocks),
                             1),
        "bound_ms": max(t_b, t_f) * 1e3,
        "bound_by": "bytes" if t_b >= t_f else "operations",
        "point": f"c3_dot1 {M} x {K} x {N} bf16, R {R}, G {G}, nacc 8 "
                 f"(wgmma: {'transposed' if plan.trans else 'direct'} "
                 f"m64n{plan.n}, {plan.nacc} accumulators), {blocks} blocks",
        "dots": dots}
    # the library's time for the same sums: sum_i A[i] @ B is one product
    # [M, R K] @ [R K, N] of the R operands side by side along K and B
    # stacked R times; Bt copies of it, operands within LIB_L2_BYTES so
    # that they stay in L2, one torch.matmul replayed from a CUDA graph,
    # scaled per product to the kernel's ``dots``
    a_cat = A.permute(1, 0, 2).reshape(M, R * K)
    bt = max(1, int(LIB_L2_BYTES // (a_cat.numel() * 2)))
    a_b = a_cat.unsqueeze(0).repeat(bt, 1, 1).contiguous()
    b_st = B.repeat(R, 1).contiguous()
    lib = torch.matmul(a_b[:1], b_st).float()[0]
    torch.cuda.synchronize()
    lib_err = float((lib - probe.mma_probe_plain(A, B, 1)[0]).abs().max())
    lib_call_ms = _graph_ms(lambda: torch.matmul(a_b, b_st), reps=50)
    del a_b
    out["probe_mma"].update(
        library_ms=lib_call_ms * dots / (bt * R),
        library_call=f"torch.matmul([{bt}, {M}, {R * K}] @ [{R * K}, {N}]) "
                     "bf16, CUDA-graph replay",
        library_call_ms=lib_call_ms, library_products=bt * R,
        library_max_abs_err=lib_err)
    # probe_stage: K 4, G 2048, the tma arm at the default depth.  Bytes
    # the function must move: the blocks n % M < min(G, M) of the K stacks
    # read once (later steps fetch them again, from L2), the output
    # written once; operations: one fp32 add per element and step; and the
    # sum is a chain of G dependent adds per element: G times the latency
    # of one, timed on the card, at the SM clock read while the launches
    # run.  ``ms`` is device time (graph replay); ``wrapper_ms`` puts the
    # events around the Python call instead, its host work included
    Ks, Gs = 4, 2048
    args = stage.make_inputs(Ks, 0, 0, dev)
    st_ms, st_wrap = {}, {}
    for arm in stage.ARMS:
        st_ms[arm] = probe.median_ms(lambda: probe.stage_probe(*args, Gs, arm))
        st_wrap[arm] = _wrapper_ms(lambda: probe.stage_probe(*args, Gs, arm))
    mhz = _sm_clock_during(lambda: probe.stage_probe(*args, Gs), st_ms["tma"])
    fadd = stage.fadd_clocks()
    st_by = min(Gs, args[0][0].shape[0]) * Ks * 4096 + 4096
    terms = {"bytes": st_by / HBM_BYTES_PER_S * 1e3,
             "operations": Gs * 8 * 128 / FP32_FLOP_PER_S * 1e3,
             "chain": Gs * fadd / (mhz * 1e6) * 1e3}
    term = max(terms, key=terms.get)
    out["probe_stage"] = {
        "ms": st_ms["tma"], "arm": "tma", "depth": stage.DEPTH,
        "cp_async_ms": st_ms["cp_async"],
        "wrapper_ms": st_wrap["tma"], "cp_async_wrapper_ms":
            st_wrap["cp_async"],
        "plain_ms": _cuda_ms(lambda: probe.stage_probe_plain(*args, Gs), 1),
        "bound_ms": terms[term],
        # the chain is G dependent operations
        "bound_by": "bytes" if term == "bytes" else "operations",
        "bound_term": term, "bound_terms_ms": terms, "sm_mhz": mhz,
        "fadd_clocks": fadd,
        "library_ms": None, "bound_bytes": st_by,
        "ns_per_step": st_ms["tma"] * 1e6 / Gs,
        "point": f"K {Ks} tiles of 4 KB a step, G {Gs} steps, tma ring of "
                 f"{stage.DEPTH}"}
    # probe_window: 4096 windows, x aligned to 16 elements, both arms
    # (device time of a graph replay).  Bound: the larger of the bytes --
    # the windows overlap, so each canvas cell that these offsets touch is
    # read once and written once, and the offsets are read once -- and the
    # chain: the longest run of windows each overlapping an earlier one
    # (``window.chain_length``), each a dependent round trip through L2
    # timed on the card (``window.rt_clocks``) at the SM clock read while
    # the kernel's launches run
    align = 16
    off = torch.from_numpy(window.make_offsets(align)).to(dev)
    canvas = torch.zeros((window.H, window.W), device=dev)
    # (``blocks``: the grid of each arm's launches, as its launcher
    # reports it)
    w_ms, w_blocks = {}, {}
    for arm in window.ARMS:
        probe.window_probe.blocks = 0
        w_ms[arm] = probe.median_ms(lambda: probe.window_probe(
            canvas, off, align, check_offsets=False, arm=arm))
        w_blocks[arm] = probe.window_probe.blocks
    assert all(b > 1 for b in w_blocks.values()), \
        f"probe_window launched {w_blocks} blocks"
    touched = window.cells_touched(off, window.W)
    w_by = 2 * touched * 4 + off.numel() * 4
    chain = window.chain_length(off)
    rt = window.rt_clocks()
    # (the wrapper's host work, some tens of us, paces these launches)
    w_mhz = _sm_clock_during(lambda: probe.window_probe(
        canvas, off, align, check_offsets=False), max(w_ms["tma"], 0.05))
    w_terms = {"bytes": w_by / HBM_BYTES_PER_S * 1e3,
               "chain": chain * rt / (w_mhz * 1e6) * 1e3}
    w_term = max(w_terms, key=w_terms.get)
    # the library's time for the same function: every sum is a small
    # integer, exact in fp32 in any order, so one accumulating index call
    # of ones at the windows' cell indices (built once, outside the timed
    # call) gives the loop's canvas bit for bit; the fastest of three
    idx = window.cell_index(off, window.W)
    ones = torch.ones(idx.numel(), device=dev)
    ref = probe.window_probe_plain(
        torch.zeros((window.H, window.W), device=dev), off, align)
    flat = torch.zeros(window.H * window.W, device=dev)
    calls = {
        "index_add_": lambda c: c.index_add_(0, idx, ones),
        "scatter_add_": lambda c: c.scatter_add_(0, idx, ones),
        "index_put_(accumulate=True)":
            lambda c: c.index_put_((idx,), ones, accumulate=True)}
    lib_ms, lib_equal = {}, {}
    for lname, call in calls.items():
        got = call(torch.zeros_like(flat)).view(window.H, window.W)
        lib_equal[lname] = bool(torch.equal(got, ref))
        assert lib_equal[lname], f"{lname} differs from the plain version"
        lib_ms[lname] = _graph_ms(lambda: call(flat), reps=50)
    lib_best = min(lib_ms, key=lib_ms.get)
    del idx, ones, flat
    out["probe_window"] = {
        "ms": w_ms["tma"], "arm": "tma", "cp_async_ms": w_ms["cp_async"],
        "plain_ms": _cuda_ms(
            lambda: probe.window_probe_plain(canvas, off, align), 1),
        "bound_ms": w_terms[w_term],
        # the chain is a run of dependent operations
        "bound_by": "bytes" if w_term == "bytes" else "operations",
        "bound_term": w_term, "bound_terms_ms": w_terms,
        "chain_length": chain, "rt_clocks": rt, "sm_mhz": w_mhz,
        "library_ms": lib_ms[lib_best], "library_call": lib_best,
        "library_ms_by_call": lib_ms, "library_bit_equal": lib_equal,
        "bound_bytes": w_by, "cells_touched": touched,
        "blocks": w_blocks,
        "point": f"{window.N} windows 8 x 128 fp32 of a {window.H} x "
                 f"{window.W} canvas, x aligned to {align}"}
    for name, t in out.items():
        old = {k: v for k, v in t.items() if k in (
            "mma_sync_ms", "cp_async_ms", "wrapper_ms", "cp_async_wrapper_ms",
            "fadd_clocks", "sm_mhz", "bound_terms_ms", "chain_length",
            "rt_clocks", "library_call", "library_ms_by_call",
            "library_bit_equal", "blocks")}
        print(f"[timing] {name} ({t['point']}): kernel {t['ms']:.4f} ms "
              f"{old}, plain {t['plain_ms']:.3f} ms, bound "
              f"{t['bound_ms']:.6f} ms ({t.get('bound_term', t['bound_by'])})"
              f", library {t['library_ms']}  [{card}]")
    return out


def drive_cli(card):
    """python -m volq_torch.cli, in process, on the card: c1 with
    checkpoint and resume, c1 against the CPU, c2 through kernels A and
    B.  Returns the launch counts of c1's frame under engine=warp on its
    Pallas path."""
    import numpy as np
    from volq_torch import _build
    from volq_torch.cli import main as cli
    with tempfile.TemporaryDirectory() as tmp:
        j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
        t0 = time.perf_counter()
        assert cli(["--preset", "c1", "--frames", "3", "--out", j("full"),
                    "--npy"]) == 0
        assert cli(["--preset", "c1", "--frames", "2", "--out", j("part"),
                    "--png", "--npy", "--checkpoint", j("ck.npz")]) == 0
        assert cli(["--preset", "c1", "--resume", j("ck.npz"), "--frames",
                    "1", "--out", j("rest"), "--npy"]) == 0
        assert cli(["--preset", "c1", "--device", "cpu", "--frames", "1",
                    "--out", j("cpu"), "--npy"]) == 0
        dt = time.perf_counter() - t0
        with open(j("part", "frame_0001.png"), "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        full = np.load(j("full", "frame_0002.npy"))
        rest = np.load(j("rest", "frame_0000.npy"))
        first = np.load(j("full", "frame_0000.npy"))
        cpu = np.load(j("cpu", "frame_0000.npy"))
        d = float(np.abs(first - cpu).max())
        print(f"[main] cli c1 (exact engine, 256 x 256 ortho): 3 + 2 + 1 "
              f"frames on the card and 1 on the CPU in {dt:.2f} s; resumed "
              f"frame equal to the uninterrupted run's "
              f"{np.array_equal(full, rest)}; card vs CPU max diff {d:.3e}; "
              f"alpha max {float(full[..., 3].max()):.4f}")
        assert full.shape == (256, 256, 4) and np.isfinite(full).all()
        assert full[..., 3].max() > 0.05
        assert np.array_equal(full, rest), "resume is not frame-exact"
        assert d <= 1e-5, f"exact engine on the card vs the CPU: {d}"

        # the sharded frame through the command line: one rank on the card
        # over NCCL, its second frame against the unsharded run's
        t0 = time.perf_counter()
        assert cli(["--preset", "c1", "--frames", "2", "--out", j("mesh"),
                    "--npy", "--mesh", "1"]) == 0
        dt = time.perf_counter() - t0
        sharded = np.load(j("mesh", "frame_0001.npy"))
        d = float(np.abs(sharded - np.load(j("full", "frame_0001.npy"))).max())
        print(f"[mesh] cli c1 --mesh 1: 2 frames in {dt:.2f} s (rank "
              f"process included); second frame vs the unsharded run's max "
              f"diff {d:.3e} (budget {SAME_TOL:.0e})")
        assert d <= SAME_TOL, f"cli --mesh 1 vs unsharded: {d}"

        # c1 through the warp engine: (i) as shipped plus engine=warp, the
        # XLA path (plain torch, no kernel); (ii) warp_pallas=true, kernels
        # A and B in their orthographic mode.  Each on the card and on the
        # CPU; (i) against (ii) within the reference's fp32 budget
        warp = ["--set", "render.engine=warp"]
        imgs = {}
        for tag, flags, want in (
                ("xla", warp, {}),
                ("pallas", warp + ["--set", "render.warp_pallas=true"],
                 {"warp_march": 1, "warp_composite": 1})):
            _build.launches.clear()
            t0 = time.perf_counter()
            assert cli(["--preset", "c1", "--frames", "1", "--out",
                        j("w" + tag), "--npy"] + flags) == 0
            dt = time.perf_counter() - t0
            counts = _counts()
            assert cli(["--preset", "c1", "--device", "cpu", "--frames",
                        "1", "--out", j("w" + tag + "_cpu"), "--npy"]
                       + flags) == 0
            img = np.load(j("w" + tag, "frame_0000.npy"))
            cpu = np.load(j("w" + tag + "_cpu", "frame_0000.npy"))
            d = float(np.abs(img - cpu).max())
            imgs[tag] = img
            print(f"[main] cli c1 engine=warp {tag} (256 x 256 ortho, 32 "
                  f"steps, V 32): 1 frame on the card in {dt:.2f} s, "
                  f"launches {counts}; card vs CPU max diff {d:.3e}; alpha "
                  f"max {float(img[..., 3].max()):.4f}")
            assert img.shape == (256, 256, 4) and np.isfinite(img).all()
            assert img[..., 3].max() > 0.05
            assert d <= 1e-5, f"c1 warp {tag}: card vs CPU {d}"
            for name in NAMES:
                assert counts[name] == want.get(name, 0), (tag, counts)
            c1_counts = counts
        d = float(np.abs(imgs["xla"] - imgs["pallas"]).max())
        print(f"[main] cli c1 engine=warp: XLA path vs Pallas path (A, B "
              f"ortho) max diff {d:.3e} (budget {XLA_BUDGET:.0e}, fp32)")
        assert d <= XLA_BUDGET, f"c1 XLA vs Pallas path: {d}"

        _build.launches.clear()
        t0 = time.perf_counter()
        assert cli(["--preset", "c2", "--frames", "2", "--out", j("c2"),
                    "--npy"]) == 0
        dt = time.perf_counter() - t0
        counts = _counts()
        img = np.load(j("c2", "frame_0001.npy"))
        cover = float((img[..., 3] > 0.01).mean())
        print(f"[main] cli c2 (warp, 512 x 512): 2 frames in {dt:.2f} s, "
              f"launches {counts}, alpha max {float(img[..., 3].max()):.4f}"
              f", {cover * 100:.1f}% of pixels above 0.01")
        assert counts["warp_march"] == 2 and counts["warp_composite"] == 2
        assert img.shape == (512, 512, 4) and np.isfinite(img).all()
        assert 0.05 < img[..., 3].max() <= 1.0 + 1e-6 and cover > 0.05
    return c1_counts


def time_c1_warp(card, errs):
    """ms/frame of preset c1 under engine=warp on its XLA path and on its
    Pallas path (A and B ortho), each on its own state; A and B timed
    alone at c1's shapes (ortho, march rect 128).  Returns A/B times."""
    from volq_torch.engine import loop
    from volq_torch.scene.config import c1
    warp = _with(c1(), engine="warp")
    times = None
    for tag, cfg in (("c1 warp xla", warp),
                     ("c1 warp pallas", _with(warp, warp_pallas=True))):
        state, camera, light = loop.setup(cfg)
        sb = loop.cached_slab_banks(state, None, cfg)
        time_loop(tag, (state, camera, light, None, sb), cfg, card,
                  n_frames=8)
        if sb is not None:
            times = time_fused("c1 warp", state, camera, light, cfg, sb,
                               card, errs)
    return times


def run_c2(card, errs):
    """Preset c2 as shipped (Pallas path: A and B) and with
    warp_pallas=false (the XLA path, plain torch): the XLA path's frames
    launch no kernel; the two paths' images of one state agree (fp32
    within FP32_BUDGET, bf16 within BF16_BUDGET); A and B timed against
    their bounds on c2's inputs; both loops timed.  Returns (A/B times,
    A/B launches of the Pallas run)."""
    import torch
    from volq_torch.engine import loop
    from volq_torch.render.warp import render_warp
    from volq_torch.scene.config import c2
    cfg = c2()
    xcfg = _with(cfg, warp_pallas=False)
    state, camera, light = loop.setup(cfg)
    sb = loop.cached_slab_banks(state, None, cfg)
    assert loop.cached_slab_banks(state, None, xcfg) is None
    fused = {"warp_march": 1, "warp_composite": 1}
    st_x, _, _ = drive("c2 xla", state, camera, light, xcfg, None, None, 2,
                       {})
    st_p, _, counts = drive("c2", state, camera, light, cfg, None, sb, 2,
                            fused)
    for budget, conv in ((BF16_BUDGET, lambda c: c), (FP32_BUDGET, _fp32)):
        pc, xc = conv(cfg), conv(xcfg)
        banks = loop.cached_slab_banks(st_p, None, pc)
        img_p = render_warp(st_p.particles, st_p.volumes, camera, light, pc,
                            slab_banks=banks)[0]
        img_x = render_warp(st_p.particles, st_p.volumes, camera, light,
                            xc)[0]
        d = float((img_p - img_x).abs().max())
        print(f"[main] c2 Pallas path vs XLA path image of one state, "
              f"{_mode(pc)}: max diff {d:.3e} (budget {budget:.3e})")
        assert d <= budget, f"c2 XLA vs Pallas path, {_mode(pc)}: {d}"
    times = time_fused("c2", st_p, camera, light, cfg, sb, card, errs)
    for tag, c, banks, st in (("c2", cfg, sb, st_p),
                              ("c2 xla", xcfg, None, st_x)):
        time_loop(tag, (st, camera, light, None, banks), c, card, n_frames=8)
    return times, counts


def _host(nt):
    """A NamedTuple of tensors -> the same of numpy arrays on the host,
    floating point as fp32 (the oracle widens to float64 itself)."""
    return type(nt)(*(v.detach().cpu().float().numpy()
                      if v.is_floating_point() else v.detach().cpu().numpy()
                      for v in nt))


def mesh_ref(state, camera, light, cfg, lv, sb):
    """The unsharded frames the mesh phase holds its sharded frames to:
    N_FRAMES_MESH frames of ``cfg`` from ``state`` (the config's initial
    state)."""
    from volq_torch.engine import loop
    st, img, stats = loop.frames(state, camera, light, cfg, lv, sb,
                                 n=N_FRAMES_MESH)
    return dict(cfg=cfg, image=img.cpu().numpy(), particles=_host(
        st.particles), stats={k: int(v[-1]) for k, v in stats.items()})


def run_slab(card):
    """The slab engine (plain torch) on the card: c1 with engine=slab in
    fp32 against --device cpu and the oracle on the full frame; c2 with
    engine=slab, slab_fp32=False at full size against --device cpu and
    the quantized oracle on C2_WINDOW; c2 with slab_grouped (which the
    port marches pairwise) against c2; the two loops timed.  Returns the mesh phase's
    references of c2 through the slab engine."""
    import numpy as np
    import torch
    from volq_torch.engine import loop
    from volq_torch.render.slab_oracle import render_slab_oracle
    from volq_torch.scene.config import c1, c2
    c1s = _with(c1(), engine="slab")
    c2s = _with(c2(), engine="slab", slab_fp32=False)
    ref = None
    for tag, cfg, window, tol in (("c1 slab fp32", c1s, None, SLAB_TOL),
                                  ("c2 slab bf16", c2s, C2_WINDOW,
                                   SLAB_BF16_TOL)):
        state, camera, light = loop.setup(cfg)
        t0 = time.perf_counter()
        img, stats = loop.render_only(state, camera, light, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st_c, cam_c, li_c = loop.setup(cfg, "cpu")
        d_cpu = {}
        modes = [cfg] if cfg.render.slab_fp32 else \
            [cfg, _with(cfg, slab_fp32=True)]
        for c in modes:
            im = img if c is cfg else loop.render_only(state, camera, light,
                                                       c)[0]
            d_cpu[c.render.slab_fp32] = float((im.cpu() - loop.render_only(
                st_c, cam_c, li_c, c)[0]).abs().max())
        x0, y0, w, h = window or (0, 0, cfg.render.width, cfg.render.height)
        t1 = time.perf_counter()
        oracle = render_slab_oracle(
            _host(state.particles), state.volumes.float().cpu().numpy(),
            _host(camera), _host(light), cfg, window=window)
        d_or = float(np.abs(img[y0:y0 + h, x0:x0 + w].cpu().numpy()
                            - oracle).max())
        print(f"[slab] {tag}: 1 frame in {dt:.3f} s, stats "
              f"{ {k: int(v) for k, v in stats.items()} }; card vs CPU max "
              f"diff {d_cpu[True]:.3e} in fp32 (budget {SAME_TOL:.0e})"
              + (f", {d_cpu[False]:.3e} in bf16 (budget {SLAB_TOL:.0e})"
                 if False in d_cpu else "") + f"; vs the oracle on "
              f"{w} x {h} at ({x0}, {y0}) max diff {d_or:.3e} (budget "
              f"{tol}, oracle {time.perf_counter() - t1:.1f} s); alpha max "
              f"{float(img[..., 3].max()):.4f}")
        assert tuple(img.shape) == (cfg.render.height, cfg.render.width, 4)
        assert bool(torch.isfinite(img).all())
        assert float(img[..., 3].max()) > 0.05
        assert int(stats["cap_dropped"]) == 0
        assert d_cpu[True] <= SAME_TOL, f"{tag}: card vs CPU {d_cpu}"
        assert d_cpu.get(False, 0.0) <= SLAB_TOL, f"{tag}: card vs CPU {d_cpu}"
        assert d_or <= tol, f"{tag}: vs the oracle {d_or}"
        time_loop(tag, (state, camera, light, None, None), cfg, card, fb=4,
                  n_frames=4, warmup=0)
        if cfg is c2s:
            grouped = _with(cfg, slab_grouped=True)
            img_g, _ = loop.render_only(state, camera, light, grouped)
            d = float((img_g - img).abs().max())
            print(f"[slab] c2 slab bf16 slab_grouped vs pairwise, one "
                  f"state: max diff {d:.3e} (budget {SAME_TOL:.0e}; the "
                  f"flag takes the pairwise march)")
            assert d <= SAME_TOL, f"c2 grouped vs pairwise: {d}"
            ref = mesh_ref(state, camera, light, cfg, None, None)
    return ref


def run_mesh(card, refs):
    """The sharded frame (dist/) at mesh size 1 on the card, over NCCL:
    ``refs`` (tag -> mesh_ref's record) run N_FRAMES_MESH frames each in
    one set of rank processes, each image within SAME_TOL and each
    particle state within 1e-6 of its unsharded frames, alive and
    pairs_kept equal, kernels A and B launched once a frame on the warp
    configs; in the rank process, each config's unsharded and mesh-1
    loops timed in turns (MESH_TIMING); time_frames(mesh=1) on c1; a
    mesh of 2 on this host raises naming its device count.  Returns
    rank 0's records by tag, ``ms`` the mesh-1 median ms/frame."""
    import numpy as np
    import torch
    from volq_torch.dist import make_mesh
    from volq_torch.engine import loop
    n_cards = torch.cuda.device_count()
    try:
        make_mesh(n_cards + 1)
    except ValueError as e:
        print(f"[mesh] make_mesh({n_cards + 1}) on {n_cards} card(s): {e}")
        assert f"have {n_cards}" in str(e)
    else:
        raise AssertionError("a mesh larger than the card count was made")
    mesh = make_mesh(1)
    t0 = time.perf_counter()
    recs = loop.run_sharded(mesh, [(ref["cfg"], N_FRAMES_MESH, 1)
                                   for ref in refs.values()],
                            timing=MESH_TIMING)
    print(f"[mesh] {mesh}: {len(refs)} configs x {N_FRAMES_MESH} frames in "
          f"one rank process, loops timed in turns {MESH_TIMING} (frames "
          f"a window, frames a call, warm-up calls, turns), "
          f"{time.perf_counter() - t0:.1f} s with set-up")
    out = {}
    for (tag, ref), rec in zip(refs.items(), recs):
        d = float(np.abs(rec["image"] - ref["image"]).max())
        ds = max(float(np.abs(np.asarray(a, np.float64)
                              - np.asarray(b, np.float64)).max())
                 for a, b in zip(ref["particles"], rec["state"].particles))
        warp = ref["cfg"].render.engine == "warp"
        want = N_FRAMES_MESH if warp else 0
        print(f"[mesh] {tag} at mesh 1: image vs unsharded max diff {d:.3e} "
              f"(budget {SAME_TOL:.0e}), particles {ds:.3e}, stats "
              f"{rec['stats']}, launches {rec['launches']}, wire bytes "
              f"{rec['wire']}")
        assert rec["image"].shape == ref["image"].shape
        assert d <= SAME_TOL, f"{tag}: sharded vs unsharded image {d}"
        assert ds <= 1e-6, f"{tag}: sharded vs unsharded particles {ds}"
        for k in ("alive", "pairs_kept"):
            if k in ref["stats"]:
                assert rec["stats"][k] == ref["stats"][k], (tag, k)
        for name in ("warp_march_launch", "warp_composite_launch"):
            assert rec["launches"][name] == want, (tag, rec["launches"])
        ms = {k: [w * 1e3 for w in v] for k, v in rec["times"].items()}
        med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
        print(f"[mesh] {tag}: {med['sharded']:.3f} ms/frame at mesh 1 (NCCL, "
              f"one rank process) vs {med['unsharded']:.3f} unsharded, "
              f"ratio {med['sharded'] / med['unsharded']:.3f}; windows in "
              f"turns, mesh 1 {[round(w, 3) for w in ms['sharded']]}, "
              f"unsharded {[round(w, 3) for w in ms['unsharded']]}  "
              f"[{card}]")
        out[tag] = dict(rec, ms=med["sharded"])
    time_loop("c1 exact mesh 1", None, refs["c1 exact"]["cfg"], card, fb=4,
              n_frames=16, warmup=1, mesh=1)
    return out


def bench_cli(prepared, card):
    """--bench on c3 through the command line, on the state already set
    up: its one JSON line."""
    from volq_torch.cli import main as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(["--preset", "c3", "--bench", "--frames", "16",
                  "--frames-per-launch", "8"], prepared=prepared)
    lines = buf.getvalue().strip().splitlines()
    assert rc == 0 and len(lines) == 1, lines
    rec = json.loads(lines[0])
    print(f"[loop] cli c3 --bench --frames 16 --frames-per-launch 8: "
          f"{lines[0]}  [{card}]")
    assert set(rec) == {"frame_ms", "fps", "mrays_per_s",
                        "frames_per_launch", "mesh", "stats"}
    assert rec["mrays_per_s"] > 0 and rec["frames_per_launch"] == 8
    assert rec["stats"]["rendered"] > 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from volq_torch.engine import loop
    from volq_torch._build import build_all
    from volq_torch.render import kernel as K
    from volq_torch.render.warp import (bake_slab_banks, fused_inputs,
                                        render_warp)
    from volq_torch.scene.config import c1, c3, c4, c5
    from volq_torch.scene.state import bake_volumes
    from volq_torch.sim.step import sim_step

    t_start = time.perf_counter()
    card = _card_line()
    print(f"[card] {card}")
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")

    t = build_all(verbose=True)
    print(f"[build] kernels built in {t:.1f} s")
    errs = dict.fromkeys(NAMES + PROBES, 0.0)

    # ---- the probes, then the command line on c1 and c2
    check_probes(errs)
    check_probe_sass()
    probe_counts, probe_arms, probe_recs = run_probes(card)
    probe_times = time_probes(card)
    c1_counts = drive_cli(card)
    c1_times = time_c1_warp(card, errs)
    c2_times, c2_counts = run_c2(card, errs)

    # ---- the slab engine; the unsharded frames the mesh phase holds its
    # sharded ones to (c1 exact, c2 slab, c3 and c5 with the fp32 canvas
    # the binary swap requires)
    refs = {"c1 exact": None, "c2 slab bf16": run_slab(card)}
    c1e = c1()
    state, camera, light = loop.setup(c1e)
    refs["c1 exact"] = mesh_ref(state, camera, light, c1e, None, None)

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
    c3m = _with(cfg, warp_canvas_fp32=True)
    refs["c3"] = mesh_ref(state, camera, light, c3m, None, sb)
    # inputs of the first frame, for the kernel checks
    check_fused("c3", sim_step(state, cfg), camera, light, cfg, None, errs)
    fused = {"warp_march": 1, "warp_composite": 1}
    unfused = {"warp_images": 2, "composite_chunk": 2}
    state, _, c3_counts = drive("c3", state, camera, light, cfg, None, sb,
                                N_FRAMES, fused)
    c3_times = time_fused("c3", state, camera, light, cfg, sb, card, errs,
                          sweep=True)
    time_loop("c3", (state, camera, light, None, sb), cfg, card)
    bench_cli((state, camera, light, None, sb), card)

    # ---- c3 under an orthographic camera: A's ortho mode (+ B), on c3's
    # state and slab banks (the march axis and the banks do not depend on
    # the projection)
    ocfg, ocam, hh = ortho_view(cfg, state, camera)
    print(f"[setup] c3 ortho: ortho_half_h {hh} (frames the alive "
          f"particles), march axis and slab banks of c3")
    oerrs = dict.fromkeys(NAMES, 0.0)
    check_fused("c3 ortho", sim_step(state, ocfg), ocam, light, ocfg, None,
                oerrs)
    st_o, _, c3o_counts = drive("c3 ortho", state, ocam, light, ocfg, None,
                                sb, N_FRAMES, fused)
    c3o_times = time_fused("c3 ortho", st_o, ocam, light, ocfg, sb, card,
                           oerrs)
    del state, sb, st_o
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
    c4_times = time_fused("c4", st_f, camera, light, cfg, sb, card, errs,
                          sweep=True)
    c4_times.update(time_unfused("c4", st_f, camera, light, ucfg, sb, card,
                                 sweep=True))
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
    p_times = time_fused("c4 per-step", sp_f, camera, light, pcfg, psb, card,
                         errs, sweep=True)
    p_times.update(time_unfused("c4 per-step", sp_f, camera, light, pucfg,
                                psb, card, sweep=True))
    for tag, st, c in (("c4 per-step fused", sp_f, pcfg),
                       ("c4 per-step unfused", sp_u, pucfg)):
        time_loop(tag, (st, camera, light, lv, psb), c, card)

    # ---- c4 unfused under an orthographic camera: C's ortho mode (+ D)
    oucfg, ocam4, hh4 = ortho_view(ucfg, state, camera)
    print(f"[setup] c4 ortho: ortho_half_h {hh4} (frames the alive "
          f"particles), warp_fused=False, c4's light and slab banks")
    check_unfused("c4 ortho", sim_step(state, oucfg), ocam4, light, oucfg,
                  lv, oerrs)
    so_u, _, c4o_counts = drive("c4 ortho unfused", state, ocam4, light,
                                oucfg, lv, sb, N_FRAMES_UNFUSED, unfused)
    c4o_times = time_unfused("c4 ortho", so_u, ocam4, light, oucfg, sb, card)
    del state, st_f, st_u, sp_f, sp_u, so_u, sb, psb, lv
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
    refs["c5"] = mesh_ref(state, camera, light,
                          _with(cfg, warp_canvas_fp32=True), None, None)
    st1 = sim_step(state, cfg)
    lv = loop._light_volumes(st1, light, cfg)
    for what, fn in (
            ("4-D bank bake", lambda: bake_volumes(cfg, "cuda", st1.time)),
            ("light bake", lambda: loop._light_volumes(st1, light, cfg)),
            ("slab bake (both banks)",
             lambda: bake_slab_banks(st1.volumes, lv, cfg))):
        print(f"[bake] c5 {what}: {_wall_ms(fn, 3):.3f} ms per frame  "
              f"[{card}]")
    noise_rec = check_noise_bake(cfg, st1.time, card)
    sim_rec = check_sim_kernel(cfg, card)
    light_rec = check_light_kernel(cfg, st1.volumes, light, card)
    check_fused("c5", st1, camera, light, cfg, lv, errs, run=RUN)
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
    # the 4-D bank and its light bank are re-baked every frame: one
    # noise-kernel and one light-kernel launch each
    state, _, c5_counts = drive("c5", state, camera, light, cfg, None, None,
                                N_FRAMES_C5,
                                dict(fused, noise_bake=1, light_bake=1),
                                no_copies=True)
    c5_times = time_fused("c5", state, camera, light, cfg, None, card, errs,
                          sweep=True)
    time_loop("c5", (state, camera, light, None, None), cfg, card,
              fb=N_FRAMES_C5, n_frames=N_FRAMES_C5, warmup=0)
    del state
    torch.cuda.empty_cache()

    # ---- the sharded frame at mesh 1 (one rank process, NCCL)
    mesh_recs = run_mesh(card, refs)

    sources = {name: f"volq_torch/csrc/{name}.cu" for name in NAMES + PROBES}
    replaces = {"warp_march": "volq/render/kernel.py:175",
                "warp_composite": "volq/render/kernel.py:175",
                "warp_images": "volq/render/kernel.py:2013",
                "composite_chunk": "volq/render/kernel.py:2159",
                "probe_mma": "bench/mxu_probe.py:78",
                "probe_stage": "bench/specs_probe.py:31",
                "probe_window": "bench/granule_probe.py:72"}
    launches = dict(u_counts, warp_march=c4_counts["warp_march"],
                    warp_composite=c4_counts["warp_composite"])
    kernels = []
    for name in NAMES:
        k = {"name": name, "route": "cuda", "source": sources[name],
             "replaces": replaces[name], "launches": launches[name],
             "max_abs_err": errs[name], **c4_times[name],
             "library_ms": None, "path": "c4"}
        # the other paths through the same kernel
        # launches through the sharded frame's route (mesh 1)
        for tag in ("c3", "c5"):
            if name in ("warp_march", "warp_composite"):
                k[f"{tag}_mesh1"] = {
                    "launches": mesh_recs[tag]["launches"][f"{name}_launch"],
                    "frame_ms": mesh_recs[tag]["ms"]}
        for path, counts, times in (("c1_warp", c1_counts, c1_times),
                                    ("c2", c2_counts, c2_times),
                                    ("c3", c3_counts, c3_times),
                                    ("c3_ortho", c3o_counts, c3o_times),
                                    ("c4_ortho", c4o_counts, c4o_times),
                                    ("c4_perstep", p_counts, p_times),
                                    ("c5", c5_counts, c5_times)):
            if name in times:
                k[path] = {"launches": counts[name], **times[name]}
        kernels.append(k)
    # the orthographic mode of A (c3's state) and of C (c4's, unfused)
    for name, path, counts, times in (
            ("warp_march", "c3_ortho", c3o_counts, c3o_times),
            ("warp_images", "c4_ortho", c4o_counts, c4o_times)):
        kernels.append({
            "name": f"{name} ortho", "route": "cuda",
            "source": sources[name], "replaces": replaces[name],
            "launches": counts[name], "max_abs_err": oerrs[name],
            **times[name], "library_ms": None, "path": path})
    # the noise bank's bake: no TPU kernel (XLA fused it)
    kernels.append({"name": "noise_bake", "route": "cuda",
                    "source": "volq_torch/csrc/noise_bake.cu",
                    "replaces": None,
                    "launches": c5_counts["noise_bake"],
                    "frames": N_FRAMES_C5, **noise_rec, "library_ms": None,
                    "path": "c5"})
    # the sim step: no TPU kernel (XLA fused it)
    kernels.append({"name": "sim_step", "route": "cuda",
                    "source": "volq_torch/csrc/sim_step.cu",
                    "replaces": None, "launches": c5_counts["sim_step"],
                    "frames": N_FRAMES_C5, **sim_rec, "library_ms": None,
                    "path": "c5"})
    # the light bank's sweep: no TPU kernel (XLA compiled its lax.scan)
    kernels.append({"name": "light_bake", "route": "cuda",
                    "source": "volq_torch/csrc/light_bake.cu",
                    "replaces": None, "launches": c5_counts["light_bake"],
                    "frames": N_FRAMES_C5, **light_rec, "library_ms": None,
                    "path": "c5"})
    for name in PROBES:
        k = {"name": name, "route": "cuda", "source": sources[name],
             "replaces": replaces[name], "launches": probe_counts[name],
             "max_abs_err": errs[name], **probe_times[name],
             "path": "probes"}
        if name in probe_arms:
            k["launches_by_arm"] = probe_arms[name]
            k["max_abs_err_by_arm"] = {arm: errs[name, arm]
                                       for arm in probe_arms[name]}
        if name == "probe_window":
            k["tma_box_at"] = {r["align"]: r["box"]
                               for r in probe_recs["window"] if r["box"]}
        if name == "probe_mma":
            k["max_rel_err"] = errs["probe_mma_rel", "wgmma"]
            k["max_rel_err_by_arm"] = {
                arm: errs["probe_mma_rel", arm] for arm in ("mma_sync",
                                                            "wgmma")}
        kernels.append(k)
    print(f"[time] every phase, the builds included: "
          f"{time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
