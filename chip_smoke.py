#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (volq_torch) on one card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without the
final result line):
  1. print the card (nvidia-smi name, power limit) and torch/CUDA versions;
  2. build the kernels from volq_torch/csrc/ (one nvcc per source, in
     parallel) and print the build seconds;
  3. set up preset c3 at full size (1024 particles, 1024 x 128^3 bank,
     1920x1080) and bake its slab banks;
  4. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes (all 1024 particles of a c3 frame), in bf16
     (c3's mode) and fp32: warp_march within 1e-5 with equal clamp
     counts, warp_composite bit-equal;
  5. drive the main path: frames(n=8) from zeroed launch counters, which
     must show one launch of each kernel per frame, a finite image with
     a plausible alpha range and rendered particles; time each kernel and
     its plain version at the main path's inputs, and the frame loop
     with engine.loop.time_frames on the state already set up;
  6. print the kernels JSON line, the card line, and last the result
     line {"ok": true, "device": {...}}.

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
# fp32 rate outside the tensor cores (both kernels are fp32 CUDA-core code)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
N_FRAMES = 8


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


def check_kernels(state, camera, light, cfg, bank):
    """Phase 4: kernel vs plain version at the main path's shapes (all
    1024 particles of a c3 frame).  Returns the max abs errors
    {kernel name: err}."""
    import torch
    from volq_torch.render import kernel as K
    from volq_torch.render.warp import fused_inputs, bake_slab_banks
    H = cfg.render.height
    cfg32 = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_fp32=True, warp_canvas_fp32=True))
    bank32 = bake_slab_banks(state.volumes, None, cfg32)[0]
    errs = {"warp_march": 0.0, "warp_composite": 0.0}
    for c, b in ((cfg, bank), (cfg32, bank32)):
        march, comp, _ = fused_inputs(state.particles, camera, light, c, b,
                                      0, H)
        pk, ck = K.warp_march(*march)
        pp, cpl = K.warp_march_plain(*march)
        torch.cuda.synchronize()
        err = float((pk - pp).abs().max())
        mode = "fp32" if c.render.warp_fp32 else "bf16"
        print(f"[kernels] warp_march {mode} N={march[-1].N}: "
              f"max|kernel - plain| = {err:.3e}, shift_clamped "
              f"{int(ck[0])} vs {int(cpl[0])}, P2 max {float(pk.max()):.4f}")
        assert err <= 1e-5, f"warp_march {mode} disagrees: {err}"
        assert int(ck[0]) == int(cpl[0]), "shift_clamped disagrees"
        assert float(pk.max()) > 0.0, "warp_march produced an empty P2"
        errs["warp_march"] = max(errs["warp_march"], err)
        del pp

        canvas0 = K.canvas_init(c, H, pk.device)
        out_k = K.warp_composite(canvas0.clone(), pk, *comp)
        out_p = K.warp_composite_plain(canvas0.clone(), pk, *comp)
        torch.cuda.synchronize()
        d = float((out_k.float() - out_p.float()).abs().max())
        touched = float((out_k.float() - canvas0.float()).abs().max())
        print(f"[kernels] warp_composite {mode}: bit-equal "
              f"{torch.equal(out_k, out_p)}, max diff {d:.3e}, "
              f"max change vs blank canvas {touched:.4f}")
        assert torch.equal(out_k, out_p), f"warp_composite {mode} differs"
        assert touched > 0.0, "warp_composite left the canvas blank"
        errs["warp_composite"] = max(errs["warp_composite"], d)
    del bank32
    return errs


def bounds(march, comp, canvas):
    """Least time the card needs for each kernel's work on these inputs:
    max(bytes moved / HBM rate, flops / fp32 rate), in ms."""
    import torch
    from volq_torch.render import kernel as K
    bank, vidx, pgeom, rxu, ryw, camf, mp = march
    valid = pgeom[:, K.PG_VALID] > 0
    nv = int(valid.sum())
    stacks = int(torch.unique(vidx[valid]).numel())
    N, RM, S = mp.N, mp.RM, mp.S
    a_bytes = (stacks * S * mp.VX * mp.V * bank.element_size()
               + N * (K.PG_N * 4 + 4 + 2 * RM * 4) + N * RM * RM * 4)
    a_flops = nv * RM * RM * (12 * S + 80)
    cp = comp[4]
    RP = cp.RP
    b_bytes = (2 * canvas.numel() * canvas.element_size()
               + nv * RM * RM * 4 + N * (4 + 4 + 12 + 4))
    b_flops = nv * RP * RP * 30

    def b(by, fl):
        t_b, t_f = by / HBM_BYTES_PER_S, fl / FP32_FLOP_PER_S
        return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")
    return {"warp_march": b(a_bytes, a_flops),
            "warp_composite": b(b_bytes, b_flops)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from volq_torch.engine import loop
    from volq_torch.render import kernel as K
    from volq_torch.render._build import build_all
    from volq_torch.render.warp import fused_inputs
    from volq_torch.scene.config import c3

    card = _card_line()
    print(f"[card] {card}")
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")

    t = build_all(verbose=True)
    print(f"[build] kernels built in {t:.1f} s")

    cfg = c3()
    t0 = time.perf_counter()
    state, camera, light = loop.setup(cfg)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    print(f"[setup] c3 setup (bank bake {tuple(state.volumes.shape)} "
          f"{state.volumes.dtype} + particle init): {t_setup:.2f} s")
    t0 = time.perf_counter()
    sb = loop.cached_slab_banks(state, None, cfg)
    torch.cuda.synchronize()
    print(f"[setup] slab banks {tuple(sb[0].shape)} {sb[0].dtype}: "
          f"{time.perf_counter() - t0:.2f} s")

    # inputs of the first frame, for the kernel checks and timings
    from volq_torch.sim.step import sim_step
    st1 = sim_step(state, cfg)
    errs = check_kernels(st1, camera, light, cfg, sb[0])

    # ---- main path, counted
    for fn in (K.warp_march, K.warp_composite):
        fn.launches = 0
    t0 = time.perf_counter()
    state, image, stats = loop.frames(state, camera, light, cfg, None, sb,
                                      n=N_FRAMES)
    torch.cuda.synchronize()
    t_frames = time.perf_counter() - t0
    launches = {"warp_march": K.warp_march.launches,
                "warp_composite": K.warp_composite.launches}
    print(f"[main] frames(n={N_FRAMES}) in {t_frames:.3f} s, launches "
          f"{launches}, stats of the last frame "
          f"{ {k: int(v[-1]) for k, v in stats.items()} }")
    for name, n in launches.items():
        assert n == N_FRAMES, f"{name} launched {n} times in {N_FRAMES} " \
                              "frames"
    H, W = cfg.render.height, cfg.render.width
    assert tuple(image.shape) == (H, W, 4), image.shape
    assert bool(torch.isfinite(image).all()), "non-finite pixels"
    alpha = image[..., 3]
    a_min, a_max = float(alpha.min()), float(alpha.max())
    cover = float((alpha > 0.01).float().mean())
    print(f"[main] alpha in [{a_min:.4f}, {a_max:.4f}], "
          f"{cover * 100:.1f}% of pixels above 0.01")
    assert a_min >= 0.0 and a_max <= 1.0 + 1e-6 and a_max > 0.05
    assert int(stats["rendered"][-1]) > 0

    # ---- kernel timings at the main path's inputs (last frame's state)
    march, comp, _ = fused_inputs(state.particles, camera, light, cfg,
                                  sb[0], 0, H)
    P2m, _ = K.warp_march(*march)
    canvas = K.canvas_init(cfg, H, P2m.device)
    ms = {"warp_march": _cuda_ms(lambda: K.warp_march(*march), 20),
          "warp_composite": _cuda_ms(
              lambda: K.warp_composite(canvas, P2m, *comp), 20)}
    plain_ms = {"warp_march": _cuda_ms(
                    lambda: K.warp_march_plain(*march), 3),
                "warp_composite": _cuda_ms(
                    lambda: K.warp_composite_plain(canvas, P2m, *comp), 1)}
    bnd = bounds(march, comp, canvas)
    for name in ms:
        print(f"[timing] {name}: kernel {ms[name]:.4f} ms, plain "
              f"{plain_ms[name]:.3f} ms, bound {bnd[name][0]:.4f} ms "
              f"({bnd[name][1]})  [{card}]")

    band = []
    spf, last = loop.time_frames(cfg, 16, warmup=1, fb=N_FRAMES, windows=3,
                                 window_times=band,
                                 prepared=(state, camera, light, sb))
    mrays = W * H / spf / 1e6
    print(f"[loop] c3 time_frames: {spf * 1e3:.3f} ms/frame, "
          f"{mrays:.2f} Mrays/s (windows "
          f"{[round(w * 1e3, 3) for w in band]} ms/frame)  [{card}]")

    sources = {"warp_march": "volq_torch/csrc/warp_march.cu",
               "warp_composite": "volq_torch/csrc/warp_composite.cu"}
    kernels = [{"name": name, "route": "cuda", "source": sources[name],
                "replaces": "volq/render/kernel.py:175",
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": ms[name], "plain_ms": plain_ms[name],
                "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
                "library_ms": None} for name in sources]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
