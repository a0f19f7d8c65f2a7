"""The orthographic mode of kernels A and C (``MarchParams.ortho``) and of
their plain versions, against the JAX package's ``march_warp_pallas``
under an ortho camera (interpret mode on the CPU; the reference has no
test of its own for Pallas under ortho) and the numpy oracle: fused (A
+ B) and unfused (C + D), unlit, center-lit and per-step lit, a yawed
camera (the constant-ratio row fan runs) and one looking along -z
(szn < 0), on tiny scenes.  The unfused cases march a rect of 32 below
the rect of 48 (C's upsample) on x-resampled slab banks; the oracle
takes an ortho camera only where the march rect is the rect, and holds
the cases that do.

Budgets are the ones the persp cases hold (tests/test_torch_warp.py):
fp32 within 1e-4 of JAX and 1e-3 of the oracle, bf16 within 4/256 of
both.  Stats, shift_clamped included, are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volq.scene.config as JC
from volq.engine.loop import setup, render_only
from volq.oracle.warp_cpu import render_warp_oracle
from volq.volume.lightbake import bake_light_volumes, dominant_axis
import volq_torch.scene.config as TC
from volq_torch.convert import (state_from_numpy, camera_from_numpy,
                                light_from_numpy)
from volq_torch import _build
from volq_torch.engine import loop as TL
from volq_torch.render import kernel as K, warp as tw

STATS = ("alive", "rendered", "straddled", "rect_overflow", "shift_clamped")
EYES = {"yawed": (3.0, 1.0, -4.5), "behind": (0.2, 0.4, 5.0)}
LIGHT = {"unlit": {}, "center": dict(light_steps=4, light_mode="center"),
         "perstep": dict(light_steps=4, light_mode="march")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small scenes: one intra-op thread is as fast, and does not fight
    the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tiny_cfg, view="yawed", fp32=False, light="unlit", **kw):
    return dataclasses.replace(
        tiny_cfg,
        camera=JC.CameraConfig(eye=EYES[view], look_at=(0.0, 0.0, 0.0),
                               projection="ortho", ortho_half_h=2.0),
        render=dataclasses.replace(
            tiny_cfg.render, engine="warp", warp_pallas=True, warp_rect=48,
            warp_fp32=fp32, warp_canvas_fp32=fp32,
            **{**dict(warp_shift_max=6), **LIGHT[light], **kw}))


def _port(cfg):
    return TC.from_json(JC.to_json(cfg))


def _check(cfg):
    """The port's render (kernels' plain versions) against the JAX Pallas
    path and the oracle; returns the port's stats."""
    st, cam, li = setup(cfg)
    ref, ref_stats = render_only(st, cam, li, cfg)
    ref = np.asarray(ref, np.float64)
    lv = None
    if cfg.render.light_steps > 0:
        lv = np.asarray(bake_light_volumes(
            st.volumes, jnp.asarray(li.direction),
            axis=dominant_axis(cfg.light.direction)))
    oracle = None
    if not cfg.render.warp_march_rect:
        oracle = render_warp_oracle(st.particles, st.volumes, cam, li, cfg,
                                    light_volumes=lv)
    tst = state_from_numpy(jax.device_get(st), "cpu")
    img, stats = TL.render_only(tst, camera_from_numpy(cam, "cpu"),
                                light_from_numpy(li, "cpu"), _port(cfg))
    img = img.numpy().astype(np.float64)
    assert img[..., 3].max() > 0.05
    tol_jax, tol_oracle = ((1e-4, 1e-3) if cfg.render.warp_fp32
                           else (4 / 256, 4 / 256))
    assert np.abs(img - ref).max() <= tol_jax
    if oracle is not None:
        assert np.abs(img - oracle).max() <= tol_oracle
    for k in STATS:
        assert int(stats[k]) == int(ref_stats[k]), k
    return stats


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("light", ["unlit", "center"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_ortho_pallas_matches_jax_and_oracle(tiny_cfg, fused, light, fp32):
    rect = {} if fused else dict(warp_march_rect=32, warp_slab_vx=8)
    cfg = _cfg(tiny_cfg, fp32=fp32, light=light, warp_fused=fused, **rect)
    assert tw.needs_row_fan(_port(cfg))
    assert int(_check(cfg)["rendered"]) > 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_ortho_perstep_lit_matches_jax(tiny_cfg, fused):
    """Per-step lit under ortho (full-x slab banks, as the mode takes)."""
    _check(_cfg(tiny_cfg, light="perstep", warp_fused=fused))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_ortho_looking_along_minus_z(tiny_cfg, fused):
    """fwd_z < 0: every particle has szn = -1 (the t > 0 test flips)."""
    cfg = _cfg(tiny_cfg, view="behind", warp_fused=fused)
    tc = _port(cfg)
    state, camera, light = TL.setup(tc, device="cpu")
    pc, cc = tw.permute_for_march(state.particles, camera, tc)
    geom, _ = tw._grid_geometry(pc, cc, tc, 0, tc.render.height)
    assert bool((geom["szn"] < 0).all())
    _check(cfg)


def test_ortho_shift_clamp_counts_match(tiny_cfg):
    """With a shift max below the fan's reach the Kc clamp cuts shifts:
    the count equals the reference's, fused and unfused."""
    for fused in (True, False):
        cfg = _cfg(tiny_cfg, warp_fused=fused, warp_shift_max=1)
        assert int(_check(cfg)["shift_clamped"]) > 0


def test_ortho_grid_geometry_matches(tiny_cfg):
    """ray_coords, _plane_pos_coeffs and _grid_geometry's ortho branches
    against the reference's."""
    from volq.render import warp as jw
    cfg = _cfg(tiny_cfg)
    st, cam, li = setup(cfg)
    jp, _, jc, _ = jw.permute_for_march(st.particles, st.volumes, cam,
                                        None, cfg)
    ref, ref_stats = jax.jit(jw._grid_geometry, static_argnums=(2, 3, 4))(
        jp, jc, cfg, 0, 64)
    tst = state_from_numpy(jax.device_get(st), "cpu")
    tp, tc = tw.permute_for_march(tst.particles, camera_from_numpy(cam, "cpu"),
                                  _port(cfg))
    got, stats = tw._grid_geometry(tp, tc, _port(cfg), 0, 64)
    for k in ("sx0", "sy0", "valid", "szn"):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy())
    for k in ("px_c", "py_c", "vz", "scale", "rx_u", "ry_w", "foot_w",
              "foot_h"):
        a, b = np.asarray(ref[k]), got[k].numpy()
        assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(a).max()), k
    for k in ref_stats:
        assert int(stats[k]) == int(ref_stats[k]), k
    zw = jnp.linspace(-1.0, 1.0, 5, dtype=jnp.float32)
    want = jw._plane_pos_coeffs(jc, "ortho")(zw)
    got = tw._plane_pos_coeffs(tc, "ortho")(torch.tensor(np.asarray(zw)))
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6)


def test_ortho_wrappers_on_cpu_run_plain(tiny_cfg):
    """On the CPU the wrappers of A and C take their ortho plain versions
    and count no launch; the params carry the mode."""
    for fused in (True, False):
        cfg = _port(_cfg(tiny_cfg, warp_fused=fused, warp_march_rect=32))
        state, camera, light = TL.setup(cfg, device="cpu")
        bank = TL.cached_slab_banks(state, None, cfg)[0]
        n0 = _build.launches.copy()
        if fused:
            march, _, _ = tw.fused_inputs(state.particles, camera, light,
                                          cfg, bank, 0, 64)
            assert march[6].ortho == 1
            got, ref = K.warp_march(*march), K.warp_march_plain(*march)
        else:
            chunks, _ = tw.unfused_inputs(state.particles, camera, light,
                                          cfg, bank, 0, 64)
            args = chunks[0][0]
            assert args[6].ortho == 1
            got, ref = K.warp_images(*args), K.warp_images_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert float(got[0].float().max()) > 0.0
        assert _build.launches == n0
