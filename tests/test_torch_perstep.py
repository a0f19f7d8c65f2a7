"""volq_torch.render: the per-step lit march (``light_mode="march"``) --
both slab stacks sampled at every step, the OVER recurrence, steps
reversed for particles behind the eye plane -- fused and unfused,
against the JAX package's Pallas paths (interpret mode on the CPU) and
the numpy oracle (the cases of tests/test_warp.py's per-step tests).

Budgets: fp32 within 1e-4 of JAX and 2e-5 of the oracle on the fused
cell canvas (1e-3 elsewhere, the reference's own); bf16 within one bf16
ulp of the JAX path (the fused images are equal to 1e-6; the unfused
path's image expansion ``alb*(lcol*P1 + amb*P2)`` is contracted into
fused multiply-adds by XLA and rounds a few pixels the other way) and
within 4/256 of the oracle.  Stats exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import volq.scene.config as JC
from volq.engine import loop as JL
from volq.engine.loop import setup, render_only, _light_volumes
from volq.oracle.warp_cpu import render_warp_oracle
import volq_torch.scene.config as TC
from volq_torch.convert import (state_from_numpy, camera_from_numpy,
                                light_from_numpy)
from volq_torch import _build
from volq_torch.engine import loop as TL
from volq_torch.render import kernel as K
from volq_torch.render import warp as tw

STATS = ("alive", "rendered", "straddled", "rect_overflow", "shift_clamped")
BF16 = dict(warp_fp32=False, warp_canvas_fp32=False)
BEHIND = JC.CameraConfig(eye=(0.2, 0.6, 5.0), look_at=(0.0, 0.0, 0.0))
INSIDE = JC.CameraConfig(eye=(-1.5, 0.3, -0.8), look_at=(0.5, 0.0, 1.6),
                         fov_y_deg=100.0)


def warpify(cfg, **kw):
    assert cfg.render.light_mode == "march" and cfg.render.light_steps > 0
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, engine="warp", warp_pallas=True, warp_rect=48,
        warp_chunk=4, **kw))


def _port(cfg):
    return TC.from_json(JC.to_json(cfg))


def _scene(cfg):
    state, camera, light = setup(cfg)
    tst = state_from_numpy(jax.device_get(state), "cpu")
    tli = light_from_numpy(light, "cpu")
    return ((state, camera, light),
            (tst, camera_from_numpy(camera, "cpu"), tli),
            TL._light_volumes(tst, tli, _port(cfg)))


def _render(t, cfg, lv, **kw):
    tst, tcam, tli = t
    if kw:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, **kw))
    return tw.render_warp(tst.particles, tst.volumes, tcam, tli, _port(cfg),
                          light_volumes=lv)


def _bf16_ulps_apart(a, b):
    """Largest |a - b| in units of the bf16 ulp of the larger value
    (floored at 2^-8, where the fp32 finish adds its own 1e-6)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(
        np.maximum(np.abs(a), np.abs(b)), 2.0 ** -8))) - 7)
    return float((np.abs(a - b) / ulp).max())


def _cases(lit):
    return {
        "fused-fp32": warpify(lit),
        "fused-bf16-behind": dataclasses.replace(warpify(lit, **BF16),
                                                 camera=BEHIND),
        "fused-fp32-coarse": warpify(lit, warp_march_rect=32, warp_coarse=1),
        "fused-bf16-pair-rm32-vx8": warpify(lit, warp_march_rect=32,
                                            warp_slab_vx=8, warp_pair=1,
                                            warp_pack=4, **BF16),
        "unfused-fp32": warpify(lit, warp_fused=False),
        "unfused-bf16-rm32-behind": dataclasses.replace(
            warpify(lit, warp_fused=False, warp_march_rect=32, **BF16),
            camera=BEHIND),
    }


@pytest.mark.filterwarnings("ignore:warp_pair=1 requested")
@pytest.mark.parametrize("case", [
    "fused-fp32", "fused-bf16-behind", "fused-fp32-coarse",
    "fused-bf16-pair-rm32-vx8", "unfused-fp32", "unfused-bf16-rm32-behind"])
def test_perstep_matches_jax_and_oracle(tiny_lit_cfg, case):
    cfg = _cases(tiny_lit_cfg)[case]
    j, t, lv = _scene(cfg)
    ref, ref_stats = render_only(*j, cfg)
    ref = np.asarray(ref, np.float64)
    jlv = np.asarray(_light_volumes(j[0], j[2], cfg))
    oracle = render_warp_oracle(j[0].particles, j[0].volumes, j[1], j[2],
                                cfg, light_volumes=jlv)
    img, stats = _render(t, cfg, lv)
    img = img.numpy().astype(np.float64)
    assert img.shape == ref.shape and img[..., 3].max() > 0.05
    if cfg.render.warp_fp32:
        tol_jax = 1e-4
        tol_oracle = 2e-5 if cfg.render.warp_coarse else 1e-3
        assert np.abs(img - ref).max() <= tol_jax
    else:
        tol_oracle = 4 / 256
        assert _bf16_ulps_apart(img, ref) <= 1.0
        if cfg.render.warp_fused:
            assert np.abs(img - ref).max() <= 1e-6
    assert np.abs(img - oracle).max() <= tol_oracle
    for k in STATS:
        assert int(stats[k]) == int(ref_stats[k]), k
    # the per-step bank keeps its full x extent whatever warp_slab_vx says
    V = cfg.volume.size
    assert tw.slab_vx_eff(_port(cfg), V) == V


def test_perstep_differs_from_center_and_unlit(tiny_lit_cfg):
    """The light changes the colour and never the coverage; per-step and
    center-lit are different images of the same scene."""
    cfg = warpify(tiny_lit_cfg)
    _, t, lv = _scene(cfg)
    step, _ = _render(t, cfg, lv)
    center, _ = _render(t, cfg, lv, light_mode="center")
    unlit, _ = _render(t, cfg, None)
    # (the fan shifts P2 when per-step lit and the optical depth when
    # unlit, so the coverage agrees only to the fan's interpolation)
    assert float((step[..., 3] - unlit[..., 3]).abs().max()) <= 0.03
    assert float((unlit[..., :3] - step[..., :3]).max()) > 0.01
    assert float((unlit[..., :3] - step[..., :3]).min()) >= -0.03
    assert float((center - step).abs().max()) > 1e-3


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
def test_flip_follows_the_eye_plane(tiny_lit_cfg, fp32):
    """A camera inside the cloud: valid particles on both sides of the
    eye plane, so some march their steps in descending order and some in
    ascending, each by its own flag.  The image is the JAX path's and
    the oracle's (which accumulates both orders and selects)."""
    cfg = dataclasses.replace(
        warpify(tiny_lit_cfg, warp_fp32=fp32, warp_canvas_fp32=fp32),
        camera=INSIDE)
    j, t, lv = _scene(cfg)
    pcfg = _port(cfg)
    tst, tcam, tli = t
    bank, lbank = tw.bake_slab_banks(tst.volumes, lv, pcfg)
    assert lbank.shape == bank.shape == (4, 8, 16, 16)
    march, _, _ = tw.fused_inputs(tst.particles, tcam, tli, pcfg, bank, 0,
                                  64, lbank)
    mp, pgeom = march[6], march[2]
    assert mp.lit == K.PERSTEP == tw.light_mode(pcfg, lbank)
    live = pgeom[:, K.PG_VALID] > 0
    flipped = (pgeom[:, K.PG_SZN] < 0) & live
    assert 0 < int(flipped.sum()) < int(live.sum())
    Pm, _ = K.warp_march(*march)
    assert float((Pm[flipped, 1] - Pm[flipped, 0]).max()) > 0.01
    ref, _ = render_only(*j, cfg)
    oracle = render_warp_oracle(
        j[0].particles, j[0].volumes, j[1], j[2], cfg,
        light_volumes=np.asarray(_light_volumes(j[0], j[2], cfg)))
    img, _ = _render(t, cfg, lv)
    img = img.numpy().astype(np.float64)
    tol_jax, tol_oracle = (1e-4, 1e-3) if fp32 else (1e-6, 4 / 256)
    assert img[..., 3].max() > 0.05
    assert np.abs(img - np.asarray(ref)).max() <= tol_jax
    assert np.abs(img - oracle).max() <= tol_oracle


@pytest.mark.filterwarnings("ignore:warp_pair=1 requested")
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_perstep_frames_match_reference(fused):
    """c4's flags with ``light_mode="march"`` through cached banks and
    frames(n=3), as the reference's suite runs its c4:perstep row."""
    c = JC.c4()
    cfg = dataclasses.replace(
        c, n_particles=16,
        volume=JC.VolumeConfig(size=16, bank_size=3, octaves=2,
                               noise_scale=5.0),
        render=dataclasses.replace(
            c.render, width=128, height=64, tile_w=32, steps=8,
            warp_rect=48, warp_march_rect=32, warp_slab_vx=8, warp_mega=8,
            near_fade_start=0.0, near_fade_end=0.0, light_mode="march",
            warp_fused=fused))
    s, cam, li = JL.setup(cfg)
    lv = JL.cached_light_volumes(s, li, cfg)
    sb = JL.cached_slab_banks(s, lv, cfg)
    s, img, stats = JL.frames(s, cam, li, cfg, lv, sb, n=3)
    tcfg = _port(cfg)
    ts, tcam, tli = TL.setup(tcfg, device="cpu")
    tlv = TL.cached_light_volumes(ts, tli, tcfg)
    tsb = TL.cached_slab_banks(ts, tlv, tcfg)
    assert tuple(tsb[1].shape) == tuple(sb[1].shape) == (3, 8, 16, 16)
    ts, timg, tstats = TL.frames(ts, tcam, tli, tcfg, tlv, tsb, n=3)
    img = np.asarray(img)
    assert timg.shape == img.shape and img[..., 3].max() > 0.05
    assert np.abs(timg.numpy() - img).max() <= 4 / 256
    for k, v in tstats.items():
        np.testing.assert_array_equal(np.asarray(stats[k]), v.numpy())


def test_perstep_wrappers_on_cpu_run_plain_and_count_nothing(tiny_lit_cfg):
    cfg = _port(warpify(tiny_lit_cfg, warp_march_rect=32, **BF16))
    _, (tst, tcam, tli), lv = _scene(warpify(tiny_lit_cfg,
                                             warp_march_rect=32, **BF16))
    bank, lbank = tw.bake_slab_banks(tst.volumes, lv, cfg)
    n0 = _build.launches.copy()
    march, comp, _ = tw.fused_inputs(tst.particles, tcam, tli, cfg, bank, 0,
                                     64, lbank)
    Pm, clamp = K.warp_march(*march)
    ref, ref_clamp = K.warp_march_plain(*march)
    assert tuple(Pm.shape) == (8, 2, 32, 32)
    assert torch.equal(Pm, ref) and torch.equal(clamp, ref_clamp)
    assert float(Pm.min()) >= 0.0 and float(Pm.max()) <= 1.0
    assert float((Pm[:, 1] - Pm[:, 0]).min()) >= -1e-6       # P1 <= P2
    ucfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_fused=False))
    (img_args, comp_args), = tw.unfused_inputs(
        tst.particles, tcam, tli, ucfg, bank, 0, 64, lbank)[0]
    images, clamp_u = K.warp_images(*img_args)
    assert images.dtype == torch.bfloat16
    assert tuple(images.shape) == (8, 4, 48, 48)
    assert torch.equal(clamp_u, clamp)
    assert _build.launches == n0
    with pytest.raises(ValueError, match="light slab bank"):
        K.warp_march(*march[:7])
