"""volq_torch.render + engine: c5's slice -- the cell canvas of
``warp_coarse`` / ``warp_canvas_scale``, ``warp_interleave``'s
association, the flags that keep the image (``warp_bands``,
``warp_canvas_vmem``, ``warp_hazard_passes``) and the animated frame
loop -- against the JAX package's fused Pallas path (interpret mode on
the CPU) and the numpy oracle, on tiny scenes carrying c5's render
flags (the cases of tests/test_warp.py's coarse, interleave and
canvas_scale tests).

Budgets: fp32 within 2e-5 of the oracle (the reference's own for these
modes) and 1e-4 of JAX; bf16 within 1e-6 of the JAX path (the canvases
agree; what is left is the fp32 cell -> pixel upsample, which XLA
contracts into fused multiply-adds) and within the reference's 8/256 of
the oracle.  The stats are exact.
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
from volq.render import kernel as jk
import volq_torch.scene.config as TC
from volq_torch.convert import (state_from_numpy, state_to_numpy,
                                camera_from_numpy, light_from_numpy)
from volq_torch.engine import loop as TL
from volq_torch.render import kernel as K
from volq_torch.render import warp as tw

STATS = ("alive", "rendered", "straddled", "rect_overflow", "shift_clamped")
BF16 = dict(warp_fp32=False, warp_canvas_fp32=False)


def warpify(cfg, **kw):
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


LAYOUTS = {"pixel": {}, "coarse": dict(warp_coarse=1),
           "scale07": dict(warp_canvas_scale=0.7)}


@pytest.mark.parametrize("ilv", [0, 1], ids=["planes", "ilv"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_canvas_geom_matches(tiny_cfg, layout, ilv):
    cfg = warpify(tiny_cfg, warp_march_rect=32, warp_interleave=ilv,
                  **LAYOUTS[layout])
    for h in (64, 33):
        ref, got = jk.canvas_geom(cfg, h), K.canvas_geom(_port(cfg), h)
        assert got._fields == ref._fields
        for f in ref._fields:
            assert getattr(got, f) == getattr(ref, f), (f, h)
        assert got.cells == (layout != "pixel")
        assert got.Wx * got.e == got.Wc
        c2m = float(np.float32(31 / 47) / np.float32(ref.ratio))
        assert K.cell_to_march(got, 32, 48) == c2m
        assert (c2m == 1.0) == (layout == "coarse")
        # the port's canvas is the reference's, de-interleaved
        init = np.asarray(jk.canvas_init_pallas(cfg, h, fused=True)
                          .astype(np.float32))
        if ilv:
            init = init.reshape(ref.Hc, ref.Wc // 4, 4).transpose(2, 0, 1)
        mine = K.canvas_init(_port(cfg), h, "cpu")
        assert mine.dtype == torch.float32     # tiny_cfg's canvas type
        np.testing.assert_array_equal(init, mine.float().numpy())


def _cases(tiny_cfg, tiny_lit_cfg):
    yaw = JC.CameraConfig(eye=(2.2, 0.6, -4.4), look_at=(0.2, 0.0, 0.0))
    front = JC.CameraConfig(eye=(0.2, 0.4, -5.0), look_at=(0, 0, 0))
    lit = dict(light_mode="center", **BF16)
    return {
        "coarse": warpify(tiny_cfg, warp_march_rect=32, warp_coarse=1),
        "coarse-ilv": warpify(tiny_cfg, warp_march_rect=32, warp_coarse=1,
                              warp_interleave=1),
        "coarse-ilv-lit-bf16": warpify(
            tiny_lit_cfg, warp_march_rect=32, warp_coarse=1,
            warp_interleave=1, **lit),
        "coarse-ilv-yawed": dataclasses.replace(
            warpify(tiny_cfg, warp_march_rect=32, warp_coarse=1,
                    warp_interleave=1), camera=yaw),
        "ilv": warpify(tiny_cfg, warp_interleave=1),
        "ilv-rm32": warpify(tiny_cfg, warp_interleave=1, warp_march_rect=32),
        "ilv-lit-bf16": dataclasses.replace(
            warpify(tiny_lit_cfg, warp_interleave=1, **lit), camera=front),
        "scale075": warpify(tiny_cfg, warp_march_rect=32,
                            warp_canvas_scale=0.75),
        "scale075-ilv-vmem-pair-lit-bf16": warpify(
            tiny_lit_cfg, warp_march_rect=32, warp_canvas_scale=0.75,
            warp_interleave=1, warp_pair=1, warp_canvas_vmem=1, **lit),
    }


CASES = ["coarse", "coarse-ilv", "coarse-ilv-lit-bf16", "coarse-ilv-yawed",
         "ilv", "ilv-rm32", "ilv-lit-bf16", "scale075",
         "scale075-ilv-vmem-pair-lit-bf16"]


@pytest.mark.filterwarnings("ignore:warp_pair=1 requested")
@pytest.mark.parametrize("case", CASES)
def test_c5_flags_match_jax_and_oracle(tiny_cfg, tiny_lit_cfg, case):
    cfg = _cases(tiny_cfg, tiny_lit_cfg)[case]
    j, t, lv = _scene(cfg)
    ref, ref_stats = render_only(*j, cfg)
    ref = np.asarray(ref, np.float64)
    jlv = _light_volumes(j[0], j[2], cfg)
    oracle = render_warp_oracle(
        j[0].particles, j[0].volumes, j[1], j[2], cfg,
        light_volumes=None if jlv is None else np.asarray(jlv))
    img, stats = _render(t, cfg, lv)
    img = img.numpy().astype(np.float64)
    assert img.shape == ref.shape and img[..., 3].max() > 0.05
    tol_jax, tol_oracle = ((1e-4, 2e-5) if cfg.render.warp_fp32
                           else (1e-6, 8 / 256))
    assert np.abs(img - ref).max() <= tol_jax
    assert np.abs(img - oracle).max() <= tol_oracle
    for k in STATS:
        assert int(stats[k]) == int(ref_stats[k]), k


@pytest.mark.parametrize("layout", ["pixel", "coarse"])
def test_interleave_is_an_association_not_a_layout(tiny_lit_cfg, layout):
    """With and without ``warp_interleave`` the port's bf16 images differ
    (the colour coefficients are rounded into the x weights), T does
    not, and each equals its JAX counterpart's canvas: so the flag is no
    no-op in the port, and no more than the reference's change."""
    base = warpify(tiny_lit_cfg, warp_march_rect=32, light_mode="center",
                   **BF16, **LAYOUTS[layout])
    j, t, lv = _scene(base)
    imgs, refs = {}, {}
    for ilv in (0, 1):
        cfg = dataclasses.replace(base, render=dataclasses.replace(
            base.render, warp_interleave=ilv))
        imgs[ilv] = _render(t, cfg, lv)[0].numpy()
        refs[ilv] = np.asarray(render_only(*j, cfg)[0])
        assert np.abs(imgs[ilv] - refs[ilv]).max() <= 1e-6
    d_port = np.abs(imgs[1] - imgs[0])
    d_ref = np.abs(refs[1] - refs[0])
    assert d_port[..., :3].max() > 1e-3 and d_ref[..., :3].max() > 1e-3
    assert d_port[..., 3].max() == 0.0
    assert np.abs(d_port - d_ref).max() <= 2e-6


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
def test_window_corners_and_boxes(tiny_cfg, fp32):
    """The placement origins and window corners are the reference's; on a
    pixel canvas a box is the rect, on a cell canvas it holds the whole
    hat tent of every valid particle."""
    from volq.render import warp as jw
    for layout in sorted(LAYOUTS):
        cfg = warpify(tiny_cfg, warp_march_rect=32, warp_interleave=1,
                      warp_fp32=fp32, warp_canvas_fp32=fp32,
                      **LAYOUTS[layout])
        pcfg = _port(cfg)
        rng = np.random.default_rng(5)
        sy0 = rng.integers(-47, 64, 200).astype(np.int32)
        sx0 = rng.integers(-47, 128, 200).astype(np.int32)
        jcg, cg = jk.canvas_geom(cfg, 64), K.canvas_geom(pcfg, 64)
        ref = jw._window_corners(jax.numpy.asarray(sy0),
                                 jax.numpy.asarray(sx0), jcg, 0)
        ayf, axf, oy, ox = tw._window_corners(
            torch.from_numpy(sy0), torch.from_numpy(sx0), cg, 0)
        np.testing.assert_array_equal(np.asarray(ref[0]), ayf.numpy())
        np.testing.assert_array_equal(np.asarray(ref[1]), axf.numpy())
        np.testing.assert_array_equal(np.asarray(ref[2]), oy.numpy())
        np.testing.assert_array_equal(np.asarray(ref[3]), ox.numpy() * cg.e)
        c2m = K.cell_to_march(cg, 32, 48)
        box = tw.placement_boxes(ayf, axf, oy, ox, cg, c2m).numpy()
        assert (box[:, 0] >= 0).all() and (box[:, 1] <= cg.Hc).all()
        assert (box[:, 2] >= 0).all() and (box[:, 3] <= cg.Wx).all()
        if not cg.cells:
            np.testing.assert_array_equal(box[:, 0], ayf.numpy())
            np.testing.assert_array_equal(box[:, 1] - box[:, 0], 48)
            np.testing.assert_array_equal(box[:, 3] - box[:, 2], 48)
            continue
        # the tent: cells with (y - ayf) * c2m in (-1, RM)
        lo = np.floor(ayf.numpy() - 1.0 / c2m).astype(int) + 1
        hi = np.ceil(ayf.numpy() + 32 / c2m).astype(int)
        if layout == "coarse":
            assert (box[:, 0] <= lo).all() and (box[:, 1] >= hi).all()
        else:    # the window may cut the leak's last sliver
            assert (box[:, 0] <= lo + 1).all() and (box[:, 1] >= hi - 1).all()


def _pixel_flag_cfgs(tiny_cfg, tiny_lit_cfg):
    return {"unlit-fp32": warpify(tiny_cfg),
            "lit-bf16-pair": warpify(tiny_lit_cfg, light_mode="center",
                                     warp_pair=1, **BF16)}


@pytest.mark.filterwarnings("ignore:warp_pair=1 requested")
@pytest.mark.parametrize("which", ["unlit-fp32", "lit-bf16-pair"])
def test_bands_vmem_hazard_give_the_same_image(tiny_cfg, tiny_lit_cfg,
                                               which):
    """Disjoint pixel bands, the resident-canvas flag and the hazard
    reorder change no pixel (mirror of tests/test_warp.py's bands,
    canvas_vmem and hazard tests); banded stats sum over the bands."""
    cfg = _pixel_flag_cfgs(tiny_cfg, tiny_lit_cfg)[which]
    _, t, lv = _scene(cfg)
    one, st_1 = _render(t, cfg, lv)
    assert float(one[..., 3].max()) > 0.05
    for kw in (dict(warp_bands=2), dict(warp_bands=3),
               dict(warp_bands=2, warp_canvas_vmem=1),
               dict(warp_canvas_vmem=1),
               dict(warp_hazard_passes=2, warp_pair=0)):
        img, st = _render(t, cfg, lv, **kw)
        assert torch.equal(img, one), kw
        assert set(st) == set(STATS)
        assert int(st["alive"]) == int(st_1["alive"])
        if "warp_bands" in kw:
            assert int(st["rendered"]) >= int(st_1["rendered"])
        else:
            for k in STATS:
                assert int(st[k]) == int(st_1[k]), (kw, k)
    # a band of its own is what the caller asked for, not split again
    band, _ = _render(t, cfg, lv, warp_bands=2)
    tst, tcam, tli = t
    pcfg = _port(dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, warp_bands=2)))
    top, _ = tw.render_warp(tst.particles, tst.volumes, tcam, tli, pcfg,
                            light_volumes=lv, y_start=0, h_local=32)
    assert torch.equal(top, band[:32])


def _tiny_c5():
    """c5's sim and render flags at test size (mirror of
    tests/test_dist.py's tiny animated config)."""
    c = JC.c5()
    return dataclasses.replace(
        c, n_particles=16,
        volume=JC.VolumeConfig(size=16, bank_size=4, octaves=1,
                               animated=True, noise_scale=5.0),
        emitter=dataclasses.replace(c.emitter, radius=1.6, size_min=0.5,
                                    size_max=0.9),
        camera=JC.CameraConfig(eye=(0.0, 1.0, -5.5), look_at=(0.0, 0.2, 0.0),
                               fov_y_deg=45.0),
        render=dataclasses.replace(
            c.render, width=128, height=64, tile_w=32, steps=8,
            warp_rect=48, warp_march_rect=32, warp_mega=8,
            near_fade_start=0.0, near_fade_end=0.0))


@pytest.mark.filterwarnings("ignore:warp_pair=1 requested")
def test_animated_frames_match_reference():
    cfg = _tiny_c5()
    assert cfg.render.warp_coarse and cfg.render.warp_interleave
    s, cam, li = JL.setup(cfg)
    assert JL.cached_light_volumes(s, li, cfg) is None
    assert JL.cached_slab_banks(s, None, cfg) is None
    tcfg = _port(cfg)
    ts, tcam, tli = TL.setup(tcfg, device="cpu")
    assert TL.cached_light_volumes(ts, tli, tcfg) is None
    assert TL.cached_slab_banks(ts, None, tcfg) is None
    v0 = ts.volumes.clone()
    np.testing.assert_array_equal(
        np.asarray(s.volumes.astype(np.float32)), v0.float().numpy())
    for i in range(3):
        s, img, stats = JL.frame(s, cam, li, cfg)
        ts, timg, tstats = TL.frame(ts, tcam, tli, tcfg)
        img = np.asarray(img)
        assert timg.shape == img.shape and img[..., 3].max() > 0.05
        assert np.abs(timg.numpy() - img).max() <= 4 / 256, i
        for k in STATS:
            assert int(tstats[k]) == int(stats[k]), (i, k)
    ref, got = jax.device_get(s), state_to_numpy(ts)
    assert got.time.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(ref.time), got.time)
    # the bank was re-baked from the simulation time: it moved, and it is
    # the reference's to one bf16 ulp
    assert not torch.equal(ts.volumes, v0)
    a = np.asarray(ref.volumes.astype(np.float32))
    b = got.volumes.astype(np.float32)
    assert np.abs(a - b).max() <= 2.0 ** -8
    # a converted state carries the time the bake reads
    conv = state_from_numpy(ref, "cpu")
    assert conv.time.dtype == torch.float32
    assert float(conv.time) == float(np.asarray(ref.time))


def test_animated_frames_equal_repeated_frame():
    cfg = _port(_tiny_c5())
    s0, cam, li = TL.setup(cfg, device="cpu")
    s1, img_n, st_n = TL.frames(s0, cam, li, cfg, n=3)
    s2 = s0
    for _ in range(3):
        s2, img_1, st_1 = TL.frame(s2, cam, li, cfg)
    assert torch.equal(img_n, img_1)
    assert torch.equal(s1.volumes, s2.volumes)
    for a, b in zip(s1.particles, s2.particles):
        assert torch.equal(a, b)
    for k, v in st_1.items():
        assert int(st_n[k][-1]) == int(v)
    # stale banks handed to an animated frame are dropped, not used
    lv = TL._light_volumes(s0, li, cfg)
    sb = tw.bake_slab_banks(s0.volumes, lv, cfg)
    _, img_a, _ = TL.frame(s0, cam, li, cfg)
    _, img_b, _ = TL.frame(s0, cam, li, cfg, lv, sb)
    assert torch.equal(img_a, img_b)
    # run and time_frames accept a scene with nothing to cache
    _, images, stats = TL.run(cfg, 2, device="cpu")
    assert images[1].shape == (64, 128, 4) and stats[-1]["rendered"] > 0
    dt, last = TL.time_frames(cfg, 1, warmup=0, fb=1, windows=1,
                              device="cpu")
    assert dt > 0 and last["alive"] > 0
