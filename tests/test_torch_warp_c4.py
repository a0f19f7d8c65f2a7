"""volq_torch.render: c4's render mode -- center-lit, the paired / packed
flags, x-resampled slab banks, fused and unfused (warp_fused=False) --
against the JAX package's Pallas paths (interpret mode on the CPU) and
the numpy oracle, on tiny scenes carrying c4's render flags.

Budgets are the reference's own: fp32 within 1e-4 of JAX and 1e-3 of the
oracle (tests/test_warp.py:19), bf16 within 4/256 of both
(tests/test_warp.py:548), fused vs unfused below 1e-6 in fp32
(tests/test_warp.py:269).  The five stats are exact.  On the CPU the
kernel wrappers run their plain PyTorch versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volq.scene.config as JC
from volq.engine.loop import setup, render_only, _light_volumes
from volq.oracle.warp_cpu import render_warp_oracle
from volq.render import kernel as jk
from volq.render import warp as jw
import volq_torch.scene.config as TC
from volq_torch.convert import (state_from_numpy, camera_from_numpy,
                                light_from_numpy, light_volumes_from_numpy,
                                _to_torch)
from volq_torch import _build
from volq_torch.engine import loop as TL
from volq_torch.render import kernel as K
from volq_torch.render import warp as tw

STATS = ("alive", "rendered", "straddled", "rect_overflow", "shift_clamped")


def c4_flags(cfg, fp32=False, lit=True, **kw):
    """A tiny scene with c4's render mode (Pallas warp, center-lit,
    paired, packed, RM < RP, x-resampled slab banks, K = 6)."""
    flags = dict(engine="warp", warp_pallas=True, warp_rect=48,
                 warp_march_rect=32, warp_slab_vx=8, warp_shift_max=6,
                 light_steps=4 if lit else 0, light_mode="center",
                 warp_pair=1, warp_pack=4, warp_fp32=fp32,
                 warp_canvas_fp32=fp32)
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, **{**flags, **kw}))


def _port(cfg):
    return TC.from_json(JC.to_json(cfg))


def _scene(cfg):
    """(JAX state, camera, light), the same converted for the port, and
    the port's own light bake (None when unlit)."""
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
    img, stats = tw.render_warp(tst.particles, tst.volumes, tcam, tli,
                                _port(cfg), light_volumes=lv)
    return img, stats


@pytest.mark.filterwarnings("ignore:warp_pair=1 requested")
@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
def test_c4_fused_matches_jax_and_oracle(tiny_lit_cfg, fp32):
    cfg = c4_flags(tiny_lit_cfg, fp32)
    j, t, lv = _scene(cfg)
    ref, ref_stats = render_only(*j, cfg)
    ref = np.asarray(ref, np.float64)
    jlv = np.asarray(_light_volumes(j[0], j[2], cfg))
    oracle = render_warp_oracle(j[0].particles, j[0].volumes, j[1], j[2],
                                cfg, light_volumes=jlv)
    img_t, stats = _render(t, cfg, lv)
    img = img_t.numpy().astype(np.float64)
    assert img.shape == ref.shape and img[..., 3].max() > 0.05
    tol_jax, tol_oracle = (1e-4, 1e-3) if fp32 else (4 / 256, 4 / 256)
    assert np.abs(img - ref).max() <= tol_jax
    assert np.abs(img - oracle).max() <= tol_oracle
    for k in STATS:
        assert int(stats[k]) == int(ref_stats[k]), k
    # both packages can render from one bake: the reference's, converted
    img_c, _ = _render(t, cfg, light_volumes_from_numpy(jlv, "cpu"))
    assert np.abs(img_c.numpy() - ref).max() <= tol_jax
    # the light does something: the shadowed image is darker than unlit
    img_u, _ = _render(t, cfg, None)
    assert torch.equal(img_u[..., 3], img_t[..., 3])
    assert float((img_u[..., :3] - img_t[..., :3]).max()) > 0.01
    assert float((img_u[..., :3] - img_t[..., :3]).min()) >= -1e-6
    # the TPU pairing / packing flags give the same image
    img_p, stats_p = _render(t, cfg, lv, warp_pair=0, warp_pack=1)
    assert torch.equal(img_p, img_t)
    assert set(stats_p) == set(stats) == set(STATS)


@pytest.mark.filterwarnings("ignore:warp_pair=1 requested")
@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("lit", [True, False], ids=["lit", "unlit"])
def test_c4_unfused_matches_jax_and_oracle(tiny_lit_cfg, lit, fp32):
    cfg = c4_flags(tiny_lit_cfg, fp32, lit, warp_fused=False)
    j, t, lv = _scene(cfg)
    assert (lv is not None) == lit
    ref, ref_stats = render_only(*j, cfg)
    ref = np.asarray(ref, np.float64)
    jlv = np.asarray(_light_volumes(j[0], j[2], cfg)) if lit else None
    oracle = render_warp_oracle(j[0].particles, j[0].volumes, j[1], j[2],
                                cfg, light_volumes=jlv)
    img, stats = _render(t, cfg, lv)
    img = img.numpy().astype(np.float64)
    assert img.shape == ref.shape and img[..., 3].max() > 0.05
    tol_jax, tol_oracle = (1e-4, 1e-3) if fp32 else (4 / 256, 4 / 256)
    assert np.abs(img - ref).max() <= tol_jax
    assert np.abs(img - oracle).max() <= tol_oracle
    for k in STATS:
        assert int(stats[k]) == int(ref_stats[k]), k


@pytest.mark.parametrize("lit", [True, False], ids=["lit", "unlit"])
def test_fused_matches_unfused_fp32(tiny_lit_cfg, lit):
    """Same math, same depth order, different data movement (mirror of
    tests/test_warp.py::test_warp_fused_matches_unfused); also with the
    march at rect resolution (RM == RP, no upsample)."""
    for kw in ({}, {"warp_march_rect": 0}):
        cfg = c4_flags(tiny_lit_cfg, True, lit, **kw)
        _, t, lv = _scene(cfg)
        img_f, st_f = _render(t, cfg, lv)
        img_u, st_u = _render(t, cfg, lv, warp_fused=False)
        assert float((img_f - img_u).abs().max()) < 1e-6
        assert int(st_f["shift_clamped"]) == int(st_u["shift_clamped"])


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
def test_mega_chunked_equals_single_pass(tiny_lit_cfg, fp32):
    """Megachunking is an execution strategy: the chunks are composited
    in the same per-pixel depth order, so the image is bit-equal.  A
    chunk size that does not divide N falls to the largest divisor."""
    cfg = c4_flags(tiny_lit_cfg, fp32, warp_fused=False)
    _, t, lv = _scene(cfg)
    one, st_1 = _render(t, cfg, lv, warp_mega=0)
    for mega, size in ((2, 2), (3, 2), (4, 4), (64, 8)):
        pcfg = _port(dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, warp_mega=mega)))
        assert tw.mega_chunk(pcfg, 8) == size
        many, st_m = _render(t, cfg, lv, warp_mega=mega)
        assert torch.equal(one, many), mega
        for k in STATS:
            assert int(st_1[k]) == int(st_m[k]), k


@pytest.mark.filterwarnings("ignore:warp_pair=1 requested")
def test_rects_clipped_at_the_canvas_edge(tiny_lit_cfg):
    """A camera that pushes rects over the right and top image edges and
    culls particles whose origins the composite's clip then moves: port
    unfused vs JAX unfused, and port fused vs port unfused."""
    base = dataclasses.replace(tiny_lit_cfg, camera=dataclasses.replace(
        tiny_lit_cfg.camera, look_at=(2.2, 1.2, 0.0)))
    cfg = c4_flags(base, warp_fused=False)
    j, t, lv = _scene(cfg)
    ref, ref_stats = render_only(*j, cfg)
    img, stats = _render(t, cfg, lv)
    assert 0 < int(stats["rendered"]) < int(stats["alive"])
    assert int(stats["shift_clamped"]) > 0
    for k in STATS:
        assert int(stats[k]) == int(ref_stats[k]), k
    assert np.abs(img.numpy() - np.asarray(ref)).max() <= 4 / 256
    pcfg = _port(cfg)
    tp, tc = tw.permute_for_march(t[0].particles, t[1], pcfg)
    g, _ = tw._grid_geometry(tp, tc, pcfg, 0, 64)
    v = g["valid"]
    assert int((g["sx0"][v] + 48).max()) > 128 and int(g["sy0"][v].min()) < 0
    WH, _, Hc, _ = K._canvas_dims(pcfg, 64)
    assert int((g["sy0"][~v] + 48).max()) > Hc - WH       # the clip binds
    cfg32 = c4_flags(base, True)
    _, t, lv = _scene(cfg32)
    img_f, _ = _render(t, cfg32, lv)
    img_u, _ = _render(t, cfg32, lv, warp_fused=False)
    assert float((img_f - img_u).abs().max()) < 1e-6


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
def test_composite_chunk_matches_pallas(tiny_cfg, fp32):
    """Kernel D's function alone against composite_chunk_pallas
    (interpret mode): random images, origins that the clip moves, a
    composite order, onto a canvas that already holds something."""
    cfg = c4_flags(tiny_cfg, fp32, lit=False, warp_fused=False)
    pcfg = _port(cfg)
    n, RP, H = 6, 48, 64
    rng = np.random.default_rng(8)
    jdt, tdt = ((jnp.float32, torch.float32) if fp32
                else (jnp.bfloat16, torch.bfloat16))
    images = rng.random((n, 4, RP, RP), dtype=np.float32)
    sy0 = np.array([-60, -10, 5, 30, 70, 200], np.int32)
    sx0 = np.array([100, -70, 20, 40, 125, 300], np.int32)
    order = rng.permutation(n).astype(np.int32)
    WH, WW, Hc, Wc = K._canvas_dims(pcfg, H)
    assert (WH, WW, Hc, Wc) == jk._canvas_dims(cfg, H)
    canvas0 = rng.random((4, Hc, Wc), dtype=np.float32)
    jimg = jnp.asarray(images).astype(jdt)
    jcan = jnp.asarray(canvas0).astype(jdt)
    ref = jk.composite_chunk_pallas(
        jcan, jimg, dict(sy0=jnp.asarray(sy0), sx0=jnp.asarray(sx0)), cfg,
        0, H, order=jnp.asarray(order))
    ref = np.asarray(ref.astype(jnp.float32))
    oy = torch.from_numpy(np.clip(sy0 + RP, 0, Hc - WH).astype(np.int32))
    ox = torch.from_numpy(np.clip(sx0 + RP, 0, Wc - WW).astype(np.int32))
    assert int(oy[0]) == 0 and int(oy[-1]) == Hc - WH   # moved by the clip
    got = K.composite_chunk(
        _to_torch(np.asarray(jcan), "cpu"), _to_torch(np.asarray(jimg), "cpu"),
        oy, ox, torch.from_numpy(order),
        K.ChunkParams(n=n, RP=RP, Hc=Hc, Wc=Wc))
    assert got.dtype == tdt
    # XLA may contract C + Tw*img into one fused multiply-add
    tol = 1e-6 if fp32 else 2.0 ** -8
    assert np.abs(got.float().numpy() - ref).max() <= tol
    assert np.abs(got.float().numpy() - canvas0).max() > 0.1


def test_upsample_plain_is_the_dense_hat_product():
    """The 2-tap upsample against the reference's dense weight matrices
    (upsample_weights), with its rounding points."""
    rng = np.random.default_rng(9)
    P = rng.random((3, 32, 32), dtype=np.float32)
    Uy, Ux = tw.upsample_weights(48, 32)
    ry, rx = jw.upsample_weights(48, 32)
    np.testing.assert_array_equal(Uy, ry)
    np.testing.assert_array_equal(Ux, rx)
    assert np.allclose(Uy.sum(1), 1.0, atol=1e-6)
    for dt in (torch.float32, torch.bfloat16):
        got = K._upsample_plain(torch.from_numpy(P), 48, K._ratio_m(32, 48),
                                dt)
        rnd = lambda a: a.to(dt).to(torch.float64)        # noqa: E731
        t = rnd((rnd(torch.from_numpy(Uy)) @ rnd(torch.from_numpy(P)))
                .float())
        want = t @ rnd(torch.from_numpy(Ux))
        assert tuple(got.shape) == (3, 48, 48)
        assert float((got.double() - want).abs().max()) <= 2e-7
    same = K._upsample_plain(torch.from_numpy(P), 32, K._ratio_m(32, 32),
                             torch.float32)
    assert torch.equal(same, torch.from_numpy(P))


def test_kernel_wrappers_on_cpu_run_plain_and_count_nothing(tiny_lit_cfg):
    cfg = c4_flags(tiny_lit_cfg)
    pcfg = _port(cfg)
    _, (tst, tcam, tli), lv = _scene(cfg)
    bank, lbank = tw.bake_slab_banks(tst.volumes, lv, pcfg)
    assert lbank.shape == bank.shape == (4, 8, 8, 16)
    assert lbank.dtype == bank.dtype == torch.bfloat16
    n0 = _build.launches.copy()
    march, comp, _ = tw.fused_inputs(tst.particles, tcam, tli, pcfg, bank,
                                     0, 64, lbank)
    Pm, clamp = K.warp_march(*march)
    ref_pm, ref_clamp = K.warp_march_plain(*march)
    assert tuple(Pm.shape) == (8, 2, 32, 32)
    assert torch.equal(Pm, ref_pm) and torch.equal(clamp, ref_clamp)
    assert float((Pm[:, 1] - Pm[:, 0]).max()) > 0.01     # P1 < P2: shadow
    assert float((Pm[:, 1] - Pm[:, 0]).min()) >= 0.0
    canvas = K.canvas_init(pcfg, 64, "cpu")
    out = K.warp_composite(canvas.clone(), Pm, *comp)
    assert torch.equal(out, K.warp_composite_plain(canvas.clone(), Pm,
                                                   *comp))
    chunks, _ = tw.unfused_inputs(tst.particles, tcam, tli, pcfg, bank, 0,
                                  64, lbank)
    (img_args, comp_args), = chunks
    images, clamp_u = K.warp_images(*img_args)
    ref_im, ref_cl = K.warp_images_plain(*img_args)
    assert tuple(images.shape) == (8, 4, 48, 48)
    assert images.dtype == torch.bfloat16
    assert torch.equal(images, ref_im) and torch.equal(clamp_u, ref_cl)
    assert torch.equal(clamp_u, clamp)
    legacy = K.canvas_init(pcfg, 64, "cpu", fused=False)
    assert legacy.shape == canvas.shape
    out_u = K.composite_chunk(legacy.clone(), images, *comp_args)
    assert torch.equal(out_u, K.composite_chunk_plain(legacy.clone(), images,
                                                      *comp_args))
    assert _build.launches == n0
    # what the kernels do not take raises
    with pytest.raises(ValueError, match="light slab bank"):
        K.warp_march(*march[:7])
    with pytest.raises(ValueError, match="cc2"):
        K.warp_composite(canvas, Pm, *comp[:-1])
    with pytest.raises(TypeError):
        K.warp_images(*img_args[:7], img_args[7].double(), *img_args[8:])
    with pytest.raises(ValueError):
        K.composite_chunk(legacy, images[:, :, :-1], *comp_args)
    with pytest.raises(ValueError, match="light slab bank"):
        tw.render_warp(tst.particles, tst.volumes, tcam, tli, pcfg,
                       light_volumes=lv, slab_banks=(bank, None))
