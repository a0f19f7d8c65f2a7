"""volq_torch's CUDA kernels against their plain PyTorch versions, on the
card.  Imports neither JAX nor volq, so it also runs where only the port
is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Without a CUDA device every case skips (the kernels have no CPU mode).
Budgets: warp_march and warp_images within 1e-5 with an equal clamp
count, warp_composite and composite_chunk bit-equal (chip_smoke.py holds
the same at c3, c4 and c5 scale).  Every mode of the kernels has a case:
unlit, center-lit, per-step lit (also with every particle behind the
eye plane, steps reversed); pixel, coarse and scaled canvases, with and
without the interleaved association.
"""
import dataclasses

import pytest
import torch

from volq_torch.engine import loop
from volq_torch.render import kernel as K
from volq_torch.render.warp import fused_inputs, unfused_inputs
from volq_torch.scene.config import (SceneConfig, VolumeConfig,
                                     EmitterConfig, CameraConfig,
                                     RenderConfig)

pytestmark = pytest.mark.gpu

EYES = {"yawed": (0.3, 0.8, -5.0), "pitched": (0.0, 1.0, -5.5),
        "behind": (0.2, 0.6, 5.0)}
FRONT = ("pitched", "yawed")


def _scene(eye, fp32, **kw):
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
                            warp_canvas_fp32=fp32, density_scale=10.0,
                            **kw))


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("view", FRONT)
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


LIT = dict(light_steps=4, light_mode="center", warp_pair=1, warp_pack=4)


def _lit_setup(view, fp32, **kw):
    cfg = _scene(EYES[view], fp32, **LIT, **kw)
    state, camera, light = loop.setup(cfg, device="cuda")
    lv = loop.cached_light_volumes(state, light, cfg)
    bank, lbank = loop.cached_slab_banks(state, lv, cfg)
    assert lbank.shape == bank.shape
    return cfg, state, camera, light, lv, bank, lbank


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("view", FRONT)
def test_lit_kernels_match_plain(view, fp32):
    """Kernels A and B in center-lit mode (two planes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg, state, camera, light, _, bank, lbank = _lit_setup(view, fp32)
    march, comp, _ = fused_inputs(state.particles, camera, light, cfg,
                                  bank, 0, cfg.render.height, lbank)
    Pm, clamp = K.warp_march(*march)
    ref, ref_clamp = K.warp_march_plain(*march)
    assert tuple(Pm.shape) == (24, 2, 48, 48)
    assert float((Pm - ref).abs().max()) <= 1e-5
    assert torch.equal(clamp, ref_clamp)
    assert float((Pm[:, 1] - Pm[:, 0]).max()) > 0.01
    canvas = K.canvas_init(cfg, cfg.render.height, Pm.device)
    out = K.warp_composite(canvas.clone(), Pm, *comp)
    assert torch.equal(out, K.warp_composite_plain(canvas.clone(), Pm,
                                                   *comp))
    assert not torch.equal(out, canvas)


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("lit", [True, False], ids=["lit", "unlit"])
@pytest.mark.parametrize("mega", [0, 8], ids=["one-chunk", "mega8"])
def test_unfused_kernels_match_plain(mega, lit, fp32):
    """Kernels C and D: one chunk composited through ``order``, and
    depth-ordered megachunks carried on one canvas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    if lit:
        cfg, state, camera, light, _, bank, lbank = _lit_setup(
            "yawed", fp32, warp_fused=False, warp_mega=mega)
    else:
        cfg = _scene(EYES["yawed"], fp32, warp_fused=False, warp_mega=mega)
        state, camera, light = loop.setup(cfg, device="cuda")
        bank, lbank = loop.cached_slab_banks(state, None, cfg)[0], None
    chunks, _ = unfused_inputs(state.particles, camera, light, cfg, bank, 0,
                               cfg.render.height, lbank)
    assert len(chunks) == (3 if mega else 1)
    canvas_k = K.canvas_init(cfg, cfg.render.height, "cuda", fused=False)
    canvas_p = canvas_k.clone()
    for img_args, comp_args in chunks:
        images, clamp = K.warp_images(*img_args)
        ref, ref_clamp = K.warp_images_plain(*img_args)
        assert images.dtype == bank.dtype
        assert float((images.float() - ref.float()).abs().max()) <= 1e-5
        assert torch.equal(clamp, ref_clamp)
        canvas_k = K.composite_chunk(canvas_k, images, *comp_args)
        canvas_p = K.composite_chunk_plain(canvas_p, images, *comp_args)
        assert torch.equal(canvas_k, canvas_p)
    assert float(canvas_k[:3].float().max()) > 0.0


def test_unfused_frames_count_launches_and_match_fused():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg, state, camera, light, lv, bank, lbank = _lit_setup(
        "pitched", False, warp_fused=False, warp_mega=8)
    fns = (K.warp_march, K.warp_composite, K.warp_images, K.composite_chunk)
    n0 = [fn.launches for fn in fns]
    _, img_u, stats = loop.frames(state, camera, light, cfg, lv,
                                  (bank, lbank), n=2)
    assert [fn.launches - n for fn, n in zip(fns, n0)] == [0, 0, 6, 6]
    fcfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_fused=True))
    _, img_f, _ = loop.frames(state, camera, light, fcfg, lv, (bank, lbank),
                              n=2)
    assert [fn.launches - n for fn, n in zip(fns, n0)] == [2, 2, 6, 6]
    assert bool(torch.isfinite(img_u).all())
    assert float((img_u - img_f).abs().max()) <= 4 / 256
    assert int(stats["rendered"][-1]) > 0


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


def _fused_check(cfg, state, camera, light, bank, lbank):
    """A and B against their plain versions on one frame's inputs."""
    H = cfg.render.height
    march, comp, _ = fused_inputs(state.particles, camera, light, cfg, bank,
                                  0, H, lbank)
    Pm, clamp = K.warp_march(*march)
    ref, ref_clamp = K.warp_march_plain(*march)
    assert float((Pm - ref).abs().max()) <= 1e-5
    assert torch.equal(clamp, ref_clamp)
    assert float(Pm.max()) > 0.0
    canvas = K.canvas_init(cfg, H, Pm.device)
    out = K.warp_composite(canvas.clone(), Pm, *comp)
    assert torch.equal(out, K.warp_composite_plain(canvas.clone(), Pm, *comp))
    assert not torch.equal(out, canvas)
    return march, comp, Pm


CANVASES = {"coarse": dict(warp_coarse=1),
            "scale08": dict(warp_canvas_scale=0.8),
            "scale099": dict(warp_canvas_scale=0.99),
            "pixel": {}}


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("lit", [True, False], ids=["lit", "unlit"])
@pytest.mark.parametrize("ilv", [0, 1], ids=["planes", "ilv"])
@pytest.mark.parametrize("canvas", sorted(CANVASES))
def test_canvas_modes_match_plain(canvas, ilv, lit, fp32):
    """Kernel B's placement on cell canvases (fractional origins, the
    tent as support) and the interleaved association, each alone and
    together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    kw = dict(CANVASES[canvas], warp_interleave=ilv)
    if lit:
        cfg, state, camera, light, _, bank, lbank = _lit_setup(
            "yawed", fp32, **kw)
    else:
        cfg = _scene(EYES["yawed"], fp32, **kw)
        state, camera, light = loop.setup(cfg, device="cuda")
        bank, lbank = loop.cached_slab_banks(state, None, cfg)[0], None
    _, comp, _ = _fused_check(cfg, state, camera, light, bank, lbank)
    cg = K.canvas_geom(cfg, cfg.render.height)
    assert comp[5].ilv == ilv and cg.cells == (canvas != "pixel")
    if cg.cells:
        assert float((comp[0] - comp[0].floor()).abs().max()) > 0.0


PERSTEP = dict(light_steps=4, light_mode="march")


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("view", sorted(EYES))
def test_perstep_kernels_match_plain(view, fp32):
    """Kernels A and B per-step lit; from behind every particle has
    szn < 0 and marches its steps in descending order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = _scene(EYES[view], fp32, **PERSTEP)
    state, camera, light = loop.setup(cfg, device="cuda")
    lv = loop.cached_light_volumes(state, light, cfg)
    bank, lbank = loop.cached_slab_banks(state, lv, cfg)
    march, _, Pm = _fused_check(cfg, state, camera, light, bank, lbank)
    assert march[6].lit == K.PERSTEP
    flipped = march[2][:, K.PG_SZN] < 0
    assert bool(flipped.all()) == (view == "behind")
    assert float((Pm[:, 1] - Pm[:, 0]).max()) > 0.01      # shadowed


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("view", ["yawed", "behind"])
def test_perstep_unfused_kernels_match_plain(view, fp32):
    """Kernel C per-step lit (D takes its images as in any mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = _scene(EYES[view], fp32, warp_fused=False, warp_mega=8, **PERSTEP)
    state, camera, light = loop.setup(cfg, device="cuda")
    lv = loop.cached_light_volumes(state, light, cfg)
    bank, lbank = loop.cached_slab_banks(state, lv, cfg)
    chunks, _ = unfused_inputs(state.particles, camera, light, cfg, bank, 0,
                               cfg.render.height, lbank)
    canvas_k = K.canvas_init(cfg, cfg.render.height, "cuda", fused=False)
    canvas_p = canvas_k.clone()
    for img_args, comp_args in chunks:
        images, clamp = K.warp_images(*img_args)
        ref, ref_clamp = K.warp_images_plain(*img_args)
        assert float((images.float() - ref.float()).abs().max()) <= 1e-5
        assert torch.equal(clamp, ref_clamp)
        canvas_k = K.composite_chunk(canvas_k, images, *comp_args)
        canvas_p = K.composite_chunk_plain(canvas_p, images, *comp_args)
        assert torch.equal(canvas_k, canvas_p)
    assert float(canvas_k[:3].float().max()) > 0.0


def test_animated_coarse_frames_count_launches():
    """c5's flags at a small size: every frame re-bakes the 4-D bank, the
    light bank and the slab banks, then launches A and B once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = _scene(EYES["pitched"], False, warp_coarse=1, warp_interleave=1,
                 **LIT)
    cfg = dataclasses.replace(cfg, volume=dataclasses.replace(
        cfg.volume, animated=True))
    state, camera, light = loop.setup(cfg, device="cuda")
    assert loop.cached_light_volumes(state, light, cfg) is None
    assert loop.cached_slab_banks(state, None, cfg) is None
    n0 = (K.warp_march.launches, K.warp_composite.launches)
    v0 = state.volumes.clone()
    state, image, stats = loop.frames(state, camera, light, cfg, n=3)
    assert (K.warp_march.launches - n0[0],
            K.warp_composite.launches - n0[1]) == (3, 3)
    assert not torch.equal(state.volumes, v0)
    assert bool(torch.isfinite(image).all())
    assert int(stats["rendered"][-1]) > 0
    # on a pixel canvas bands, the resident-canvas flag and the hazard
    # reorder give the same image (disjoint pixels, same per-pixel math)
    px = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_coarse=0))
    _, img_a, _ = loop.frame(state, camera, light, px)
    alt = dataclasses.replace(px, render=dataclasses.replace(
        px.render, warp_bands=3, warp_canvas_vmem=1, warp_pair=0,
        warp_hazard_passes=1))
    _, img_b, st_b = loop.frame(state, camera, light, alt)
    assert torch.equal(img_a, img_b)
    assert int(st_b["rendered"]) > 0
