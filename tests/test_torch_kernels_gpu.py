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
without the interleaved association; the orthographic mode of A and C
(also at a march rect of 128, the largest A and C take); and the warp
engine's XLA path (plain torch) on the card against the CPU.  C's arms
(staged with the planned ring and a ring of two, global; the narrowest
and widest blocks; y-pass bands of the plan's rows, one row and every
row; RM == RP; RM 128; the global arm where no ring fits) are held at
max abs err 0 with an equal clamp count, D's cases (every canvas / image
dtype pair, through an order and as stored; a tile every image covers,
past its list slots; a list longer than one bitmap window of its order;
bf16 images as a view into a longer buffer) with torch.equal, bf16
images whose edge word reaches past their storage refused, and D's fill
kernel against chunk_lists_plain.  A's arms
(staged with the planned ring and a ring of two, global; the narrowest
and widest blocks; the global arm where no ring fits; RM 128 in both
projections) and B's edges (a tile every particle covers, with a list
longer than a block holds in shared memory and one longer than a bitmap
window of its list order; no list slots) are held at max abs err 0 (A)
and torch.equal (B); B's fill kernel against tile_lists_plain.  The
probes: both arms of probe_mma (mma_sync, wgmma) on shapes that exercise
every wgmma plan within 1e-4 of max |out| of the fp64 plain sum, both arms
of probe_stage (cp_async, tma at ring depths 2, 4, 8) and probe_window
(cp_async at align 128 / 16 / 8 / 4, tma also at 2 / 1; the reference's
windows and heavy-overlap cases) bit-equal.  The noise kernel
(``noise_bake``): c5's animated bank at four times and seeds (a large
and a negative time among them), ``ids`` subsets, and a c3-like static
bank, each bit-equal to the plain version on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from volq_torch import _build
from volq_torch.engine import loop
from volq_torch.render import kernel as K
from volq_torch.render.warp import fused_inputs, unfused_inputs
from volq_torch.scene.config import (SceneConfig, VolumeConfig,
                                     EmitterConfig, CameraConfig,
                                     RenderConfig, c3 as c3_preset,
                                     c5 as c5_preset)
from volq_torch.volume import bake as VB

pytestmark = pytest.mark.gpu

# kernels A, B, C and D by their C functions (``_build.launches``' keys)
ABCD = ("warp_march_launch", "warp_composite_launch", "warp_images_launch",
        "composite_chunk_launch")


def _since(n0, names=ABCD) -> list:
    """Launches of ``names`` since ``n0``, a copy of ``_build.launches``."""
    return [_build.launches[f] - n0[f] for f in names]

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
    n0 = _build.launches.copy()
    _, img_u, stats = loop.frames(state, camera, light, cfg, lv,
                                  (bank, lbank), n=2)
    assert _since(n0) == [0, 0, 6, 6]
    fcfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_fused=True))
    _, img_f, _ = loop.frames(state, camera, light, fcfg, lv, (bank, lbank),
                              n=2)
    assert _since(n0) == [2, 2, 6, 6]
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
    n0 = _build.launches.copy()
    state, image, stats = loop.frames(state, camera, light, cfg, None, sb,
                                      n=3)
    assert _since(n0, ABCD[:2]) == [3, 3]
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
    n0 = _build.launches.copy()
    v0 = state.volumes.clone()
    state, image, stats = loop.frames(state, camera, light, cfg, n=3)
    assert _since(n0, ABCD[:2]) == [3, 3]
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


# --------------------------------------------------------------------------
# the probe kernels (volq_torch/probe) against their plain versions

@pytest.mark.parametrize("arm", ["mma_sync", "wgmma"])
@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("nacc", [1, 8])
@pytest.mark.parametrize("shape", [(16, 32, 16), (80, 128, 64),
                                   (120, 64, 64), (64, 1280, 64),
                                   (128, 64, 256), (80, 1280, 80),
                                   (128, 1280, 128), (16, 128, 128),
                                   (120, 64, 256), (128, 128, 32),
                                   (32, 128, 128), (256, 128, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_probe_mma_matches_plain(shape, nacc, blocks, arm):
    """One tile, a 5-tile M, a ragged M, a K that streams in chunks, 16
    tiles a warp; for the wgmma arm also each of its plans: transposed
    (80 x 128 x 64, 120 x 64 x 64, n16 16 x 128 x 128, two tiles a
    warpgroup 120 x 64 x 256, n32 32 x 128 x 128), padded (16 x 32 x 16,
    and 80 x 1280 x 80 streamed), streamed (64 x 1280 x 64 with the
    products split between the warpgroups, 128 x 1280 x 128 with the tiles
    split), n256 (128 x 64 x 256), n32 (128 x 128 x 32), two tiles a
    warpgroup (256 x 128 x 128) -- every instantiation of the wgmma arm:
    within 1e-4 of max |out| of the fp64 plain sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from volq_torch import probe
    from volq_torch.probe import tensor_core
    M, Kd, N = shape
    # 8 operands of 64 x 1280 do not fit, nor 3 of 256 x 128 for mma_sync
    R = 8 if Kd == 1280 else 2 if M == 256 else 3
    A, B = tensor_core.make_inputs(R, M, Kd, N, "cuda", seed=M)
    plan = tensor_core.plan_for(arm, R, M, Kd, N, nacc)
    assert plan.resident == (Kd < 1280)
    n0 = _build.launches.copy()
    out = probe.mma_probe(A, B, 5, nacc, blocks, arm)
    ref = probe.mma_probe_plain(A, B, 5, blocks)
    fn = {"mma_sync": "probe_mma_launch", "wgmma": "probe_mma_wgmma_launch"}
    assert _build.launches - n0 == {fn[arm]: 1}
    assert tuple(out.shape) == (blocks, M, N)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert float(probe.mma_probe(A, B, 0, nacc, blocks, arm).abs().max()) \
        == 0.0


@pytest.mark.parametrize("run", [("cp_async", None), ("tma", 2), ("tma", 4),
                                 ("tma", 8)],
                         ids=lambda r: r[0] + ("" if r[1] is None
                                               else str(r[1])))
@pytest.mark.parametrize("mix", [(1, 0, 0), (4, 0, 0), (12, 0, 0),
                                 (2, 3, 0), (2, 0, 4), (16, 4, 4)],
                         ids=lambda m: "K%d-s%d-c%d" % m)
def test_probe_stage_matches_plain(mix, run):
    """Bit-equal on each arm, the tma arm at every ring depth; a ring that
    does not fit the block's shared memory is refused before a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from volq_torch import probe
    from volq_torch.probe import stage
    arm, depth = run
    args = stage.make_inputs(*mix, "cuda", M=8)
    n0 = _build.launches.copy()
    if arm == "tma" and not stage.ring_fits(*mix, depth):
        with pytest.raises(ValueError):
            probe.stage_probe(*args, 5, arm, depth)
        assert _build.launches == n0
        return
    for G in (0, 1, 2, 19, 300):
        out = probe.stage_probe(*args, G, arm, depth)
        assert torch.equal(out, probe.stage_probe_plain(*args, G)), G
    fn = {"cp_async": "probe_stage_launch", "tma": "probe_stage_tma_launch"}
    assert _build.launches - n0 == {fn[arm]: 5}


@pytest.mark.parametrize("run", [("cp_async", 128), ("cp_async", 16),
                                 ("cp_async", 8), ("cp_async", 4),
                                 ("tma", 128), ("tma", 16), ("tma", 8),
                                 ("tma", 4), ("tma", 2), ("tma", 1)],
                         ids=lambda r: f"{r[0]}-{r[1]}")
def test_probe_window_matches_plain(run):
    """Bit-equal on each arm at every alignment it takes: overlapping
    windows on a small canvas, where most of them overlap their
    predecessor; the reference's size; the heavy-overlap cases on the
    reference's canvas (every window in one band, every window identical --
    a chain of 4096 --, x within 256 of the edge, x at 0 or W - 128); more
    windows than a launch takes (two launches, in order); one band of x in
    [0, 264), where the tma arm's wide boxes share columns that their
    windows do not.  Every launch one block a band."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from volq_torch import probe
    from volq_torch.probe import window
    arm, align = run
    fn = {"cp_async": "probe_window_launch",
          "tma": "probe_window_tma_launch"}[arm]
    cases = [((24, 256), window.make_offsets(align, 257, 24, 256, seed=257)),
             ((window.H, window.W), window.make_offsets(align)),
             ((24, 256), window.make_offsets(align, window.MAX_LIST + 300,
                                             24, 256, seed=9))]
    cases += [((window.H, window.W), o)
              for o in window.overlap_cases(align, seed=align).values()]
    xs = np.random.RandomState(align).randint(0, 264 // align, 1000) * align
    cases.append(((8, 512), np.stack([np.zeros_like(xs), xs], 1)
                  .astype(np.int32).reshape(-1)))
    for (h, w), o in cases:
        off = torch.from_numpy(o)
        n = off.numel() // 2
        n0 = _build.launches.copy()
        out = probe.window_probe(torch.zeros((h, w), device="cuda"),
                                 off.cuda(), align, arm=arm)
        ref = probe.window_probe_plain(torch.zeros((h, w)), off, align)
        assert torch.equal(out.cpu(), ref), (h, w, n)
        assert float(out.sum()) == n * window.WH * window.WW
        assert _build.launches - n0 == {fn: -(-n // window.MAX_LIST)}
        assert probe.window_probe.blocks == (h - window.WH) // window.WH + 1
    with pytest.raises(ValueError):
        probe.window_probe(torch.zeros((24, 256), device="cuda"),
                           off[:8].cuda() + 2, align, arm=arm)
    # no windows: nothing launches and nothing is counted
    n0 = _build.launches.copy()
    blank = torch.zeros((24, 256), device="cuda")
    assert probe.window_probe(blank, off[:0].cuda(), align, arm=arm) is blank
    assert _build.launches == n0


def test_window_rt_clocks():
    """The chain term's round trip through L2, timed on the card: more
    than an L1 hit, less than a microsecond at any clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from volq_torch.probe import window
    assert 50 < window.rt_clocks() < 4000


# --------------------------------------------------------------------------
# the orthographic mode of kernels A and C, and the XLA path on the card

def _ortho(cfg, half_h=2.0):
    return dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, projection="ortho", ortho_half_h=half_h))


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("light", ["unlit", "center", "perstep"])
@pytest.mark.parametrize("view", ["yawed", "behind"])
def test_ortho_kernels_match_plain(view, light, fp32):
    """A (+ B) and C (+ D) in their orthographic mode against their
    plain versions, each lighting mode, looking along +z and -z."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    kw = {"unlit": {}, "center": LIT, "perstep": PERSTEP}[light]
    cfg = _ortho(_scene(EYES[view], fp32, **kw))
    state, camera, light_ = loop.setup(cfg, device="cuda")
    lv = loop.cached_light_volumes(state, light_, cfg)
    bank, lbank = loop.cached_slab_banks(state, lv, cfg)
    march, _, _ = _fused_check(cfg, state, camera, light_, bank, lbank)
    assert march[6].ortho == 1
    ucfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_fused=False, warp_mega=8))
    chunks, _ = unfused_inputs(state.particles, camera, light_, ucfg, bank,
                               0, cfg.render.height, lbank)
    for img_args, _ in chunks:
        images, clamp = K.warp_images(*img_args)
        ref, ref_clamp = K.warp_images_plain(*img_args)
        assert float((images.float() - ref.float()).abs().max()) <= 1e-5
        assert torch.equal(clamp, ref_clamp)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_ortho_kernels_at_march_rect_128(fused):
    """RM = 128 (a rect of 128 marched at full resolution, c1's under
    the warp engine): 16384 rays a block and a 64 KB fan plane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = _ortho(_scene(EYES["pitched"], True, warp_fused=fused),
                 half_h=1.0)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_rect=128, warp_march_rect=0, warp_slab_vx=0,
        steps=32))
    state, camera, light = loop.setup(cfg, device="cuda")
    bank = loop.cached_slab_banks(state, None, cfg)[0]
    if fused:
        march, _, _ = _fused_check(cfg, state, camera, light, bank, None)
        assert march[6].RM == 128
        return
    chunks, _ = unfused_inputs(state.particles, camera, light, cfg, bank, 0,
                               cfg.render.height)
    images, clamp = K.warp_images(*chunks[0][0])
    ref, ref_clamp = K.warp_images_plain(*chunks[0][0])
    assert float((images.float() - ref.float()).abs().max()) <= 1e-5
    assert torch.equal(clamp, ref_clamp)


@pytest.mark.parametrize("proj", ["persp", "ortho"])
def test_xla_path_on_the_card_matches_cpu(proj):
    """The XLA path (plain torch, no kernel) renders on the card as on the
    CPU, and launches none of the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _scene(EYES["yawed"], True)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_pallas=False))
    if proj == "ortho":
        cfg = _ortho(cfg)
    n0 = _build.launches.copy()
    imgs = []
    for dev in ("cuda", "cpu"):
        state, camera, light = loop.setup(cfg, device=dev)
        assert loop.cached_slab_banks(state, None, cfg) is None
        imgs.append(loop.render_only(state, camera, light, cfg)[0].cpu())
    assert _since(n0) == [0, 0, 0, 0]
    assert float(imgs[0][..., 3].max()) > 0.05
    assert float((imgs[0] - imgs[1]).abs().max()) <= 1e-5


# --------------------------------------------------------------------------
# the staged march (kernel A) and the per-tile lists (kernel B): their arms
# and edges, each held at max abs err 0 (A) and torch.equal (B)

def _march_equal(march, plan=None):
    Pm, clamp = K.warp_march(*march, plan=plan)
    ref, ref_clamp = K.warp_march_plain(*march)
    assert float((Pm - ref).abs().max()) == 0.0
    assert torch.equal(clamp, ref_clamp)
    assert float(Pm.max()) > 0.0
    return Pm


MODES = {"unlit": {}, "center": LIT, "perstep": PERSTEP}


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("proj", ["persp", "ortho"])
@pytest.mark.parametrize("light", sorted(MODES))
def test_march_arms_match_plain(light, proj, fp32):
    """A's staged arm (the plan's ring and a ring of two) and its global
    arm (taps from device memory), every lighting mode, both projections,
    from the front and (per-step lit: steps reversed) from behind, with
    the planned blocks (24 particles, fewer than the SMs), the narrowest
    and the widest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for view in ("yawed", "behind"):
        cfg = _scene(EYES[view], fp32, **MODES[light])
        if proj == "ortho":
            cfg = _ortho(cfg)
        state, camera, light_ = loop.setup(cfg, device="cuda")
        lv = loop.cached_light_volumes(state, light_, cfg)
        bank, lbank = loop.cached_slab_banks(state, lv, cfg)
        march, _, _ = fused_inputs(state.particles, camera, light_, cfg,
                                   bank, 0, cfg.render.height, lbank)
        mp = march[6]
        plan = K.march_plan(mp, bank.element_size())
        assert plan.stages >= 2
        _march_equal(march)
        for stages in (2, 0):
            alt = K.MarchPlan(G=plan.G, stages=stages,
                              smem=K.march_smem(mp, stages,
                                                bank.element_size()))
            _march_equal(march, alt)
        # the narrowest and the widest blocks the rect allows
        for G in (-(-mp.RM // K.MARCH_CAP), K.MARCH_BLOCK // mp.RM):
            _march_equal(march, K.MarchPlan(G=G, stages=plan.stages,
                                            smem=plan.smem))
        with pytest.raises(RuntimeError):   # a plan the kernel refuses
            K.warp_march(*march, plan=K.MarchPlan(
                G=plan.G, stages=plan.stages, smem=plan.smem + 16))


@pytest.mark.parametrize("proj", ["persp", "ortho"])
def test_march_at_rect_128_both_projections(proj):
    """RM = 128 (c1's under the warp engine): 896- and 1024-thread blocks,
    a 64 KB plane, both arms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = _scene(EYES["pitched"], True)
    if proj == "ortho":
        cfg = _ortho(cfg, half_h=1.0)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_rect=128, warp_march_rect=0, warp_slab_vx=0,
        steps=32))
    state, camera, light = loop.setup(cfg, device="cuda")
    bank = loop.cached_slab_banks(state, None, cfg)[0]
    march, _, _ = fused_inputs(state.particles, camera, light, cfg, bank, 0,
                               cfg.render.height)
    mp = march[6]
    assert mp.RM == 128 and mp.ortho == (proj == "ortho")
    plan = K.march_plan(mp, 4)
    _march_equal(march)
    # the narrowest (20 rays a thread, 896 threads) and widest blocks, and
    # the global arm
    for G in (7, 8):
        _march_equal(march, K.MarchPlan(G=G, stages=plan.stages,
                                        smem=plan.smem))
    _march_equal(march, K.MarchPlan(G=8, stages=0,
                                    smem=K.march_smem(mp, 0, 4)))


def test_march_global_arm_where_no_ring_fits():
    """Per-step lit in fp32 over full-x 128^3 slabs: a stage of two 64 KB
    slabs leaves no ring of two in 227 KB, so the plan names the global
    arm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = _scene(EYES["yawed"], True, **PERSTEP)
    cfg = dataclasses.replace(
        cfg, n_particles=6, volume=dataclasses.replace(cfg.volume, size=128,
                                                       bank_size=2),
        render=dataclasses.replace(cfg.render, warp_slab_vx=0, steps=6))
    state, camera, light = loop.setup(cfg, device="cuda")
    lv = loop.cached_light_volumes(state, light, cfg)
    bank, lbank = loop.cached_slab_banks(state, lv, cfg)
    march, _, _ = fused_inputs(state.particles, camera, light, cfg, bank, 0,
                               cfg.render.height, lbank)
    assert K.march_plan(march[6], 4).arm == "global"
    _march_equal(march)


def _synthetic_composite(N, seed, lit=True, RM=32, RP=48, Hc=96, Wc=320,
                         one_tile=False, scale=1.0):
    """Kernel B's inputs made up with numpy: random planes (times
    ``scale``), integer origins on a pixel canvas, boxes the RP x RP rects
    (``one_tile``: every rect covers canvas tile (1, 1))."""
    import numpy as np
    rng = np.random.default_rng(seed)
    dev = "cuda"
    npl = 2 if lit else 1
    Pm = torch.from_numpy(rng.random((N, npl, RM, RM), np.float32) * scale)
    Pm = (Pm.reshape(N, RM, RM) if not lit else Pm).to(dev)
    if one_tile:
        ay = rng.integers(K.TILE_H + 1 - RP, K.TILE_H, N)
        ax = rng.integers(K.TILE_W + 1 - RP, K.TILE_W, N)
    else:
        ay = rng.integers(-RP // 2, Hc - RP // 2, N)
        ax = rng.integers(-RP // 2, Wc - RP // 2, N)
    box = np.stack([np.maximum(ay, 0), np.minimum(ay + RP, Hc),
                    np.maximum(ax, 0), np.minimum(ax + RP, Wc)], 1)
    t = lambda a, dt=torch.float32: torch.from_numpy(   # noqa: E731
        np.ascontiguousarray(a)).to(dt).to(dev)
    cc = t(rng.random((N, 3)) * 0.9)
    cc2 = t(rng.random((N, 3)) * 0.3) if lit else None
    valid = t(rng.random(N) > 0.1, torch.int32)
    cp = K.composite_params(N, RM, Hc, Wc, K._ratio_m(RM, RP), lit=lit)
    canvas = torch.zeros((4, Hc, Wc), dtype=torch.float32, device=dev)
    canvas[3] = 1
    return canvas, (Pm, t(ay), t(ax), t(box, torch.int32), cc, valid, cp,
                    torch.bfloat16, cc2)


@pytest.mark.parametrize("lit", [True, False], ids=["lit", "unlit"])
def test_composite_one_tile_every_particle_covers(lit):
    """1500 particles whose rects all cover tile (1, 1): one list 1500
    long (longer than the kChunk a block holds in shared memory); then
    with no list slots (every warp tests the whole list)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    canvas, args = _synthetic_composite(1500, 5, lit=lit, one_tile=True)
    ref = K.warp_composite_plain(canvas.clone(), *args)
    assert torch.equal(K.warp_composite(canvas.clone(), *args), ref)
    cp = args[6]
    plan = K.composite_plan(cp)
    counts, _ = K.tile_fill(args[3], args[5], cp)
    assert int(counts[1 * plan.ntx + 1]) == int(args[5].sum()) > 1024
    none = K.CompositePlan(ntx=plan.ntx, nty=plan.nty, capt=0)
    assert torch.equal(K.warp_composite(canvas.clone(), *args, plan=none),
                       ref)


def test_composite_list_past_one_bitmap_window():
    """70000 particles, every one valid, all on tile (1, 1) of a 2 x 2
    tile canvas: the list is longer than one bitmap window (65536
    indices) of the block's list order.  Planes scaled down, so that the
    tile's transmittance stays well above 0 to the last particle and a
    particle out of order would change the canvas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    N = 70000
    canvas, args = _synthetic_composite(N, 9, lit=False, RM=8, RP=12,
                                        Hc=32, Wc=128, one_tile=True,
                                        scale=4e-5)
    args = args[:5] + (torch.ones_like(args[5]),) + args[6:]
    cp = args[6]
    plan = K.composite_plan(cp)
    assert plan.capt == N
    counts, _ = K.tile_fill(args[3], args[5], cp)
    assert int(counts[1 * plan.ntx + 1]) == N
    ref = K.warp_composite_plain(canvas.clone(), *args)
    assert float(ref[3, 16:, 64:].min()) > 0.05
    assert torch.equal(K.warp_composite(canvas.clone(), *args), ref)


def test_tile_fill_matches_plain():
    """B's fill kernel against tile_lists_plain: scattered rects, and
    70000 particles on one tile; each tile's slots, sorted, are its
    plain list."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for N, one in ((3000, False), (70000, True)):
        _, args = _synthetic_composite(N, N, one_tile=one)
        box, valid, cp = args[3], args[5], args[6]
        if one:
            valid = torch.ones_like(valid)
        plan = K.composite_plan(cp)
        counts, slots = K.tile_fill(box, valid, cp)
        offs, lists = K.tile_lists_plain(box.cpu(), valid.cpu(), cp.Hc,
                                         cp.Wc)
        assert torch.equal(counts.cpu(), offs[1:] - offs[:-1])
        assert int(counts.max()) <= plan.capt
        counts, slots = counts.cpu(), slots.cpu()
        for t in range(counts.numel()):
            a, b = int(offs[t]), int(offs[t + 1])
            assert torch.equal(slots[t, :b - a].sort().values, lists[a:b]), t


# --------------------------------------------------------------------------
# kernel C on the step-major march (its arms, band widths, RM == RP, RM
# 128, the global arm) at max abs err 0, and kernel D on per-tile lists
# (every dtype pair, order or none, the overflow fallback, a list past one
# bitmap window) and its fill, held with torch.equal

def _images_equal(img_args, plan=None, seen=True):
    images, clamp = K.warp_images(*img_args, plan=plan)
    ref, ref_clamp = K.warp_images_plain(*img_args)
    assert images.dtype == ref.dtype
    assert float((images.float() - ref.float()).abs().max()) == 0.0
    assert torch.equal(clamp, ref_clamp)
    assert not seen or float(images[:, :3].float().max()) > 0.0
    return images


def _unfused_chunks(cfg, mega=8):
    ucfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_fused=False, warp_mega=mega))
    state, camera, light = loop.setup(ucfg, device="cuda")
    lv = loop.cached_light_volumes(state, light, ucfg)
    bank, lbank = loop.cached_slab_banks(state, lv, ucfg)
    chunks, _ = unfused_inputs(state.particles, camera, light, ucfg, bank,
                               0, ucfg.render.height, lbank)
    return chunks, bank


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("proj", ["persp", "ortho"])
@pytest.mark.parametrize("light", sorted(MODES))
def test_images_arms_match_plain(light, proj, fp32):
    """C's staged arm (the plan's ring and a ring of two) and its global
    arm, the narrowest and widest blocks, y-pass bands of the plan's
    rows, one row and every row, each lighting mode, both projections,
    from the front and (per-step lit: steps reversed) from behind."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for view in ("yawed", "behind"):
        cfg = _scene(EYES[view], fp32, **MODES[light])
        if proj == "ortho":
            cfg = _ortho(cfg)
        chunks, bank = _unfused_chunks(cfg)
        img_args = chunks[0][0]
        mp, it = img_args[6], bank.element_size()
        assert mp.ortho == (proj == "ortho") and mp.RM < mp.RP
        plan = K.images_plan(mp, it)
        assert plan.stages >= 2 and 1 <= plan.band <= mp.RP
        ref = _images_equal(img_args)

        def alt(G=plan.G, stages=plan.stages, band=plan.band):
            return K.MarchPlan(G=G, stages=stages, band=band,
                               smem=K.images_smem(mp, stages, it, band))

        for a in (alt(stages=2), alt(stages=0), alt(band=1),
                  alt(band=mp.RP), alt(G=-(-mp.RM // K.MARCH_CAP)),
                  alt(G=K.MARCH_BLOCK // mp.RM)):
            assert torch.equal(_images_equal(img_args, a), ref)
        for bad in (K.MarchPlan(G=plan.G, stages=plan.stages, band=plan.band,
                                smem=plan.smem + 16), alt(band=0)):
            with pytest.raises(RuntimeError):   # plans the kernel refuses
                K.warp_images(*img_args, plan=bad)
        for img_args, _ in chunks[1:]:
            _images_equal(img_args, seen=False)


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("light", sorted(MODES))
def test_images_without_upsample(light, fp32):
    """RM == RP (no march rect below the rect): the epilogue is the
    identity, band 0; a band given there is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = _scene(EYES["yawed"], fp32, **MODES[light])
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_march_rect=0))
    chunks, bank = _unfused_chunks(cfg)
    img_args = chunks[0][0]
    mp = img_args[6]
    assert mp.RM == mp.RP == 64
    plan = K.images_plan(mp, bank.element_size())
    assert plan.band == 0
    _images_equal(img_args)
    with pytest.raises(RuntimeError):
        K.warp_images(*img_args, plan=K.MarchPlan(
            G=plan.G, stages=plan.stages, band=1,
            smem=K.images_smem(mp, plan.stages, bank.element_size(), 1)))


@pytest.mark.parametrize("rect", [128, 176], ids=["RP128", "RP176"])
@pytest.mark.parametrize("light", ["unlit", "center"])
def test_images_at_march_rect_128(light, rect):
    """RM = 128 (896-thread blocks, a 64 KB plane): without upsample (RP
    128) and upsampled to 176, perspective, fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = _scene(EYES["pitched"], True, **MODES[light])
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_rect=rect, warp_march_rect=128, warp_slab_vx=0,
        steps=16))
    chunks, _ = _unfused_chunks(cfg)
    img_args = chunks[0][0]
    assert img_args[6].RM == 128 and img_args[6].RP == rect
    _images_equal(img_args)


def test_images_global_arm_where_no_ring_fits():
    """Per-step lit in fp32 over full-x 128^3 slabs: no ring of two fits,
    so C's plan, like A's, names the global arm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = _scene(EYES["yawed"], True, **PERSTEP)
    cfg = dataclasses.replace(
        cfg, n_particles=6, volume=dataclasses.replace(cfg.volume, size=128,
                                                       bank_size=2),
        render=dataclasses.replace(cfg.render, warp_slab_vx=0, steps=6))
    chunks, _ = _unfused_chunks(cfg, mega=0)
    img_args = chunks[0][0]
    assert K.images_plan(img_args[6], 4).arm == "global"
    _images_equal(img_args)


def _synthetic_chunk(n, seed, RP=24, Hc=96, Wc=320, one_tile=False,
                     ordered=True, cdt=torch.float32, idt=torch.bfloat16,
                     t_min=0.2):
    """Kernel D's inputs made up with numpy: random images (RGB in [0, 1),
    T in [t_min, 1)), origins inside the canvas (``one_tile``: every rect
    covers canvas tile (1, 1)), a random composite order or none, and a
    canvas of random values (T in (0.5, 1])."""
    import numpy as np
    rng = np.random.default_rng(seed)
    dev = "cuda"
    img = rng.random((n, 4, RP, RP), np.float32)
    img[:, 3] = t_min + (1 - t_min) * img[:, 3]
    if one_tile:
        oy = rng.integers(K.TILE_H + 1 - RP, K.TILE_H, n).clip(0)
        ox = rng.integers(K.TILE_W + 1 - RP, K.TILE_W, n).clip(0)
    else:
        oy = rng.integers(0, Hc - RP + 1, n)
        ox = rng.integers(0, Wc - RP + 1, n)
    order = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev) \
        if ordered else None
    canvas = torch.from_numpy(rng.random((4, Hc, Wc), np.float32))
    canvas[3] = 0.5 + 0.5 * canvas[3]
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.int32)).to(dev)
    return (canvas.to(cdt).to(dev),
            (torch.from_numpy(img).to(idt).to(dev), t(oy), t(ox), order,
             K.ChunkParams(n=n, RP=RP, Hc=Hc, Wc=Wc)))


@pytest.mark.parametrize("ordered", [True, False], ids=["order", "stored"])
@pytest.mark.parametrize("idt", [torch.bfloat16, torch.float32],
                         ids=["img_bf16", "img_fp32"])
@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32],
                         ids=["canvas_bf16", "canvas_fp32"])
def test_chunk_dtypes_and_order_match_plain(cdt, idt, ordered):
    """D on scattered rects, every canvas / image dtype pair, through a
    composite order and as stored: torch.equal, every pixel outside every
    rect untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    canvas, args = _synthetic_chunk(600, 3, cdt=cdt, idt=idt,
                                    ordered=ordered)
    n0 = _build.launches.copy()
    out = K.composite_chunk(canvas.clone(), *args)
    assert _build.launches - n0 == {"composite_chunk_launch": 1}
    ref = K.composite_chunk_plain(canvas.clone(), *args)
    assert torch.equal(out, ref)
    assert not torch.equal(out, canvas)


def test_chunk_one_tile_every_image_covers():
    """1500 images whose rects all cover tile (1, 1): one list 1500 long
    (longer than a block holds in shared memory); then with no list slots
    (every warp tests every composite position) and with 5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    canvas, args = _synthetic_chunk(1500, 5, one_tile=True, t_min=0.9)
    ref = K.composite_chunk_plain(canvas.clone(), *args)
    assert torch.equal(K.composite_chunk(canvas.clone(), *args), ref)
    cp = args[4]
    plan = K.chunk_plan(cp)
    counts, _ = K.chunk_fill(*args[1:])
    assert int(counts[1 * plan.ntx + 1]) == 1500 > 1024
    for capt in (0, 5):
        few = K.CompositePlan(ntx=plan.ntx, nty=plan.nty, capt=capt)
        assert torch.equal(K.composite_chunk(canvas.clone(), *args,
                                             plan=few), ref)
    with pytest.raises(RuntimeError):   # a plan the kernel refuses
        K.composite_chunk(canvas.clone(), *args, plan=K.CompositePlan(
            ntx=plan.ntx + 1, nty=plan.nty, capt=plan.capt))


def test_chunk_bf16_views_and_edge_words():
    """bf16 images as a view one value into a buffer one value longer
    (the composite equal to the plain version's), and as a view whose last
    value's aligned 4-byte word reaches past its storage (refused before
    the launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    canvas, args = _synthetic_chunk(50, 7)
    images = args[0]
    m = images.numel()
    buf = torch.empty(m + 1, dtype=images.dtype, device=images.device)
    inner = buf[1:].view(images.shape)
    inner.copy_(images)
    n0 = _build.launches.copy()
    with pytest.raises(ValueError):
        K.composite_chunk(canvas.clone(), inner, *args[1:])
    assert _build.launches == n0
    buf = torch.empty(m + 2, dtype=images.dtype, device=images.device)
    inner = buf[1:-1].view(images.shape)
    inner.copy_(images)
    ref = K.composite_chunk_plain(canvas.clone(), *args)
    assert torch.equal(K.composite_chunk(canvas.clone(), inner, *args[1:]),
                       ref)


def test_chunk_list_past_one_bitmap_window():
    """70000 images, all on tile (1, 1) of a 2 x 2 tile canvas, through a
    composite order: the list is longer than one bitmap window (65536
    positions) of the block's list order.  T close to 1, so that the
    tile's transmittance stays well above 0 to the last image and an
    image out of order would change the canvas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    n = 70000
    canvas, args = _synthetic_chunk(n, 9, RP=8, Hc=32, Wc=128,
                                    one_tile=True, cdt=torch.float32,
                                    idt=torch.float32, t_min=0.99998)
    args[0][:, :3] *= 1e-3
    plan = K.chunk_plan(args[4])
    assert plan.capt == n
    counts, _ = K.chunk_fill(*args[1:])
    assert int(counts[1 * plan.ntx + 1]) == n
    ref = K.composite_chunk_plain(canvas.clone(), *args)
    assert float(ref[3, 16:, 64:].min()) > 0.05
    assert torch.equal(K.composite_chunk(canvas.clone(), *args), ref)


def test_chunk_fill_matches_plain():
    """D's fill kernel against chunk_lists_plain: scattered rects through
    an order and as stored, and 70000 images on one tile; each tile's
    slots, sorted, are its plain list."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for n, one, ordered in ((3000, False, True), (3000, False, False),
                            (70000, True, True)):
        _, args = _synthetic_chunk(n, n, RP=8 if one else 24,
                                   Hc=32 if one else 96,
                                   Wc=128 if one else 320, one_tile=one,
                                   ordered=ordered)
        oy, ox, order, cp = args[1:]
        plan = K.chunk_plan(cp)
        n0 = _build.launches.copy()
        counts, slots = K.chunk_fill(oy, ox, order, cp)
        assert _build.launches - n0 == {"composite_chunk_fill": 1}
        offs, lists = K.chunk_lists_plain(
            oy.cpu(), ox.cpu(), None if order is None else order.cpu(), cp)
        assert torch.equal(counts.cpu(), offs[1:] - offs[:-1])
        assert int(counts.max()) <= plan.capt
        counts, slots = counts.cpu(), slots.cpu()
        for t in range(counts.numel()):
            a, b = int(offs[t]), int(offs[t + 1])
            assert torch.equal(slots[t, :b - a].sort().values, lists[a:b]), t


def _bits(bank):
    return bank.view(torch.int16)


def _bake_4d(v, t, seed, ids=None, plain=False):
    """c5-like bank ``v`` at time ``t``: the kernel's, or (``plain``) the
    plain version's on the card."""
    tt = torch.tensor(t, dtype=torch.float32, device="cuda")
    if plain:
        return VB._bake_plain(v.bank_size, v.size, seed,
                              VB._noise_4d(tt, seed, v.octaves,
                                           v.time_scale),
                              v.noise_scale, v.cutoff, v.edge,
                              torch.bfloat16, tt.device, ids)
    return VB.bake_bank_4d(v.bank_size, v.size, seed, tt, octaves=v.octaves,
                           noise_scale=v.noise_scale,
                           time_scale=v.time_scale, cutoff=v.cutoff,
                           edge=v.edge, ids=ids)


@pytest.mark.parametrize("t, seed", [(0.0, 5), (0.37, 2 ** 31 + 101),
                                     (1234.5, 5), (-37.25, 2 ** 32 + 7)],
                         ids=["t0", "seed-2^31", "t-large", "t-negative"])
def test_noise_bake_4d_equals_plain_at_c5_shapes(t, seed):
    """The animated bank of c5 (16 x 64^3, 3 octaves, its noise_scale,
    cutoff and edge): one launch, bit-equal to the plain version; the
    entries' offsets put part of the lattice below 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    v = c5_preset().volume
    assert float(VB._volume_offsets(torch.arange(v.bank_size), seed)
                 .min()) < -1.0
    n0 = _build.launches.copy()
    got = _bake_4d(v, t, seed)
    assert _build.launches - n0 == {"noise_bake_launch": 1}
    assert got.shape == (16, 64, 64, 64) and got.dtype == torch.bfloat16
    assert torch.equal(_bits(got), _bits(_bake_4d(v, t, seed, plain=True)))
    assert float(got.float().max()) > 0.1


def test_noise_bake_4d_ids_subsets_equal_plain():
    """``ids`` as the sharded frame passes them (a CPU arange per rank),
    and out of order: the plain version's entries, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    v = c5_preset().volume
    whole = _bake_4d(v, 2.5, 77)
    for ids in (torch.arange(8, 16), torch.tensor([5, 0, 13, 7])):
        got = _bake_4d(v, 2.5, 77, ids=ids)
        assert torch.equal(_bits(got), _bits(_bake_4d(v, 2.5, 77, ids=ids,
                                                      plain=True)))
        assert torch.equal(_bits(got), _bits(whole[ids.cuda()]))


def test_noise_bake_3d_equals_plain_at_a_c3_like_shape():
    """The static bank of 3-D noise (c3's octaves, noise_scale, cutoff and
    edge; 6 entries of 32^3): one launch, bit-equal to the plain version;
    the plain version's fp32 bank on the card rounds to the same bf16
    bank, and the wrapper refuses an fp32 bank on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    v = c3_preset().volume
    kw = dict(octaves=v.octaves, noise_scale=v.noise_scale,
              cutoff=v.cutoff, edge=v.edge)
    n0 = _build.launches.copy()
    got = VB.bake_bank(6, 32, v.seed, **kw)
    assert _build.launches - n0 == {"noise_bake_launch": 1}
    ref = VB._bake_plain(6, 32, v.seed, VB._noise_3d(v.seed, v.octaves),
                         v.noise_scale, v.cutoff, v.edge, torch.bfloat16,
                         got.device)
    assert torch.equal(_bits(got), _bits(ref))
    assert float(got.float().max()) > 0.1
    f32 = VB._bake_plain(6, 32, v.seed, VB._noise_3d(v.seed, v.octaves),
                         v.noise_scale, v.cutoff, v.edge, torch.float32,
                         got.device)
    assert torch.equal(_bits(got), _bits(f32.to(torch.bfloat16)))
    with pytest.raises(ValueError, match="bf16"):
        VB.bake_bank(6, 32, v.seed, dtype=torch.float32, **kw)
    assert _build.launches - n0 == {"noise_bake_launch": 1}
