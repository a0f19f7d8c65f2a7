"""volq_torch's CUDA kernels against their plain PyTorch versions, on the
card.  Imports neither JAX nor volq, so it also runs where only the port
is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Without a CUDA device every case skips (the kernels have no CPU mode).
Budgets: warp_march within 1e-5 with an equal clamp count (chip_smoke.py
holds the same at c3 scale), warp_composite bit-equal.
"""
import dataclasses

import pytest
import torch

from volq_torch.engine import loop
from volq_torch.render import kernel as K
from volq_torch.render.warp import fused_inputs
from volq_torch.scene.config import (SceneConfig, VolumeConfig,
                                     EmitterConfig, CameraConfig,
                                     RenderConfig)

pytestmark = pytest.mark.gpu

EYES = {"yawed": (0.3, 0.8, -5.0), "pitched": (0.0, 1.0, -5.5)}


def _scene(eye, fp32):
    return SceneConfig(
        n_particles=24, init="random", seed=11,
        volume=VolumeConfig(size=32, bank_size=6, octaves=3),
        emitter=EmitterConfig(radius=1.6, size_min=0.5, size_max=0.9,
                              life_min=100.0, life_max=100.0,
                              albedo_var=0.3),
        camera=CameraConfig(eye=eye, look_at=(0.0, 0.2, 0.0),
                            fov_y_deg=50.0),
        render=RenderConfig(width=256, height=128, steps=12, engine="warp",
                            warp_pallas=True, warp_rect=64,
                            warp_march_rect=48, warp_slab_vx=16,
                            warp_shift_max=6, warp_fp32=fp32,
                            warp_canvas_fp32=fp32, density_scale=10.0))


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("view", sorted(EYES))
def test_kernels_match_plain(view, fp32):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = _scene(EYES[view], fp32)
    state, camera, light = loop.setup(cfg, device="cuda")
    bank = loop.cached_slab_banks(state, None, cfg)[0]
    march, comp, _ = fused_inputs(state.particles, camera, light, cfg,
                                  bank, 0, cfg.render.height)
    P2m, clamp = K.warp_march(*march)
    ref, ref_clamp = K.warp_march_plain(*march)
    assert float((P2m - ref).abs().max()) <= 1e-5
    assert torch.equal(clamp, ref_clamp)
    assert float(P2m.max()) > 0.0
    canvas = K.canvas_init(cfg, cfg.render.height, P2m.device)
    out = K.warp_composite(canvas.clone(), P2m, *comp)
    assert torch.equal(out, K.warp_composite_plain(canvas.clone(), P2m,
                                                   *comp))
    assert not torch.equal(out, canvas)


def test_frames_count_one_launch_each_per_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = dataclasses.replace(_scene(EYES["pitched"], False),
                              init="empty")
    cfg = dataclasses.replace(cfg, emitter=dataclasses.replace(
        cfg.emitter, rate=600.0, life_min=3.0, life_max=6.0))
    state, camera, light = loop.setup(cfg, device="cuda")
    sb = loop.cached_slab_banks(state, None, cfg)
    n0 = (K.warp_march.launches, K.warp_composite.launches)
    state, image, stats = loop.frames(state, camera, light, cfg, None, sb,
                                      n=3)
    assert (K.warp_march.launches - n0[0],
            K.warp_composite.launches - n0[1]) == (3, 3)
    assert bool(torch.isfinite(image).all())
    assert int(stats["rendered"][-1]) > 0
