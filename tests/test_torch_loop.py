"""volq_torch.engine: the slice as a whole -- setup, cached light bank
and slab banks, then frames(n=3) of a tiny emitting, curl-forced scene
with c3's and with c4's sim and render flags -- against
volq.engine.loop.frames, plus the loop's own contracts (frames ==
repeated frame, the card by default)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import volq.scene.config as JC
from volq.engine import loop as JL
import volq_torch.scene.config as TC
from volq_torch.convert import state_to_numpy
from volq_torch.engine import loop as TL

POS_TOL = 1e-5
BF16_TOL = 4 / 256


def _tiny_c3():
    c = JC.c3()
    return dataclasses.replace(
        c, n_particles=16,
        volume=JC.VolumeConfig(size=16, bank_size=3, octaves=2,
                               noise_scale=5.0),
        render=dataclasses.replace(
            c.render, width=128, height=64, tile_w=32, warp_rect=48,
            warp_march_rect=32, warp_slab_vx=8, near_fade_start=0.0,
            near_fade_end=0.0))


def _tiny_c4(**kw):
    c = JC.c4()
    return dataclasses.replace(
        c, n_particles=16,
        volume=JC.VolumeConfig(size=16, bank_size=3, octaves=2,
                               noise_scale=5.0),
        render=dataclasses.replace(
            c.render, width=128, height=64, tile_w=32, warp_rect=48,
            warp_march_rect=32, warp_slab_vx=8, warp_mega=8,
            near_fade_start=0.0, near_fade_end=0.0, **kw))


def _port(cfg):
    return TC.from_json(JC.to_json(cfg))


def test_frames_match_reference():
    cfg = _tiny_c3()
    s, cam, li = JL.setup(cfg)
    sb = JL.cached_slab_banks(s, None, cfg)
    s, img, stats = JL.frames(s, cam, li, cfg, None, sb, n=3)
    tcfg = _port(cfg)
    ts, tcam, tli = TL.setup(tcfg, device="cpu")
    tsb = TL.cached_slab_banks(ts, None, tcfg)
    ts, timg, tstats = TL.frames(ts, tcam, tli, tcfg, None, tsb, n=3)

    ref, got = jax.device_get(s), state_to_numpy(ts)
    for f in ref.particles._fields:
        a = np.asarray(getattr(ref.particles, f))
        b = getattr(got.particles, f)
        if f == "vol_idx":
            np.testing.assert_array_equal(a, b)
        else:
            assert np.abs(a - b).max() <= POS_TOL, f
    for f in ("frame", "spawn_carry", "time"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f))
    img = np.asarray(img)
    assert timg.shape == img.shape and img[..., 3].max() > 0.05
    assert np.abs(timg.numpy() - img).max() <= BF16_TOL
    for k, v in tstats.items():
        np.testing.assert_array_equal(np.asarray(stats[k]), v.numpy())


@pytest.mark.filterwarnings("ignore:warp_pair=1 requested")
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_c4_frames_match_reference(fused):
    """c4's flags (center-lit, paired, packed, megachunks of 8) through
    cached_light_volumes / cached_slab_banks / frames(n=3)."""
    cfg = _tiny_c4(warp_fused=fused)
    s, cam, li = JL.setup(cfg)
    lv = JL.cached_light_volumes(s, li, cfg)
    sb = JL.cached_slab_banks(s, lv, cfg)
    s, img, stats = JL.frames(s, cam, li, cfg, lv, sb, n=3)
    tcfg = _port(cfg)
    ts, tcam, tli = TL.setup(tcfg, device="cpu")
    tlv = TL.cached_light_volumes(ts, tli, tcfg)
    assert np.abs(tlv.numpy() - np.asarray(lv)).max() <= 1e-5
    tsb = TL.cached_slab_banks(ts, tlv, tcfg)
    assert tsb[1].shape == tsb[0].shape and tsb[1].dtype == tsb[0].dtype
    ts, timg, tstats = TL.frames(ts, tcam, tli, tcfg, tlv, tsb, n=3)
    img = np.asarray(img)
    assert timg.shape == img.shape and img[..., 3].max() > 0.05
    assert np.abs(timg.numpy() - img).max() <= BF16_TOL
    assert set(tstats) == {"alive", "rendered", "straddled",
                           "rect_overflow", "shift_clamped"}
    for k, v in tstats.items():
        np.testing.assert_array_equal(np.asarray(stats[k]), v.numpy())
    # without the cached banks the frame bakes both itself: same image
    ts0, _, _ = TL.setup(tcfg, device="cpu")
    _, img_a, _ = TL.frame(ts0, tcam, tli, tcfg)
    _, img_b, _ = TL.frame(ts0, tcam, tli, tcfg, tlv, tsb)
    assert torch.equal(img_a, img_b)
    # an unlit scene needs no light bank
    assert TL.cached_light_volumes(ts0, tli, _port(_tiny_c3())) is None


def test_frames_equal_repeated_frame():
    cfg = _port(_tiny_c3())
    s0, cam, li = TL.setup(cfg, device="cpu")
    sb = TL.cached_slab_banks(s0, None, cfg)
    s1, img_n, st_n = TL.frames(s0, cam, li, cfg, None, sb, n=3)
    s2 = s0
    for _ in range(3):
        s2, img_1, st_1 = TL.frame(s2, cam, li, cfg, None, sb)
    assert torch.equal(img_n, img_1)
    for a, b in zip(s1.particles, s2.particles):
        assert torch.equal(a, b)
    assert int(s1.frame) == int(s2.frame) == 3
    for k, v in st_1.items():
        assert int(st_n[k][-1]) == int(v)
    # without cached banks the frame bakes them itself: same image
    _, img_b, _ = TL.frame(s0, cam, li, cfg)
    _, img_c, _ = TL.frame(s0, cam, li, cfg, None, sb)
    assert torch.equal(img_b, img_c)


def test_setup_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.setup(_port(_tiny_c3()))
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.setup(_port(_tiny_c3()), device="cuda")


def test_run_and_time_frames_on_cpu():
    cfg = _port(_tiny_c3())
    _, images, stats = TL.run(cfg, 2, warmup=1, device="cpu")
    assert len(images) == 2 and images[0].shape == (64, 128, 4)
    assert stats[-1]["rendered"] > 0
    band = []
    dt, last = TL.time_frames(cfg, 2, warmup=0, fb=1, windows=2,
                              window_times=band, device="cpu")
    assert dt > 0 and len(band) == 2 and last["alive"] > 0
    state, camera, light = TL.setup(cfg, device="cpu")
    sb = TL.cached_slab_banks(state, None, cfg)
    dt, last = TL.time_frames(cfg, 1, warmup=0, fb=1, windows=1,
                              prepared=(state, camera, light, None, sb))
    assert dt > 0 and last["alive"] > 0
    # c4's lit, unfused mode through run and time_frames
    c4 = _port(_tiny_c4(warp_fused=False))
    _, images, stats = TL.run(c4, 1, device="cpu")
    assert images[0].shape == (64, 128, 4) and stats[-1]["rendered"] > 0
    dt, last = TL.time_frames(c4, 1, warmup=0, fb=1, windows=1,
                              device="cpu")
    assert dt > 0 and last["alive"] > 0
    # the sharded loop over two gloo processes (the binary swap needs the
    # fp32 canvas)
    band = []
    fp32 = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_canvas_fp32=True))
    dt, last = TL.time_frames(fp32, 2, warmup=0, fb=2, windows=2, mesh=2,
                              window_times=band, device="cpu")
    assert dt > 0 and len(band) == 2 and last["alive"] > 0
    with pytest.raises(ValueError, match="prepared"):
        TL.time_frames(cfg, 1, mesh=2, device="cpu",
                       prepared=(state, camera, light, None, sb))
