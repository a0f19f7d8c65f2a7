"""volq_torch's warp engine on its XLA path (``warp_pallas=False``, the
engine's default; ``volq_torch/render/warp_xla.py``) against the JAX
package's XLA path and the numpy oracle, mirroring tests/test_warp.py's
XLA-path cases: both projections, backward rays, the yawed row fan, the
one-hot and gather bank paths, lit, zero light steps, bf16, row bands,
consistency with the exact engine, and the Pallas path against the XLA
path.

Budgets: fp32 within 1e-5 of JAX and the reference's 1e-3 of the oracle
(tests/test_warp.py:19); bf16 within one bf16 ulp of the canvas's
largest values (2^-8) of JAX and the reference's 4/256 of the quantized
oracle (tests/test_warp.py:149).  Stats are exact.
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
from volq_torch.engine import loop as TL
from volq_torch.render import render_frame, warp as tw, warp_xla as tx

STATS = ("alive", "rendered", "straddled", "rect_overflow", "shift_clamped")
TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small scenes: one intra-op thread is as fast, and does not fight
    the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _warpify(cfg, **kw):
    return dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, engine="warp",
                                        warp_rect=48, warp_chunk=4, **kw))


def _port(cfg):
    return TC.from_json(JC.to_json(cfg))


def _render_both(cfg, lit=False):
    """(port image, JAX image, oracle image, port stats, JAX stats) of
    one scene; ``lit``: with the baked light volumes."""
    st, cam, li = setup(cfg)
    ref, ref_stats = render_only(st, cam, li, cfg)
    lv = None
    if lit:
        lv = np.asarray(bake_light_volumes(
            st.volumes, jnp.asarray(li.direction),
            axis=dominant_axis(cfg.light.direction)))
    oracle = render_warp_oracle(st.particles, st.volumes, cam, li, cfg,
                                light_volumes=lv)
    tst = state_from_numpy(jax.device_get(st), "cpu")
    img, stats = TL.render_only(tst, camera_from_numpy(cam, "cpu"),
                                light_from_numpy(li, "cpu"), _port(cfg))
    return (img.numpy().astype(np.float64), np.asarray(ref, np.float64),
            oracle, stats, ref_stats)


def _check(cfg, lit=False, alpha=0.05):
    img, ref, oracle, stats, ref_stats = _render_both(cfg, lit)
    assert img[..., 3].max() > alpha
    tol_jax, tol_oracle = ((1e-5, TOL) if cfg.render.warp_fp32
                           else (2.0 ** -8, 4 / 256))
    assert np.abs(img - ref).max() <= tol_jax
    assert np.abs(img - oracle).max() <= tol_oracle
    for k in STATS:
        assert int(stats[k]) == int(ref_stats[k]), k
    return img, stats


def _ortho_cfg(**cam):
    return JC.SceneConfig(
        n_particles=1, init="single", seed=1,
        volume=JC.VolumeConfig(size=16, bank_size=1, octaves=2),
        emitter=JC.EmitterConfig(size_min=1.0, size_max=1.0,
                                 life_min=100.0, life_max=100.0),
        camera=JC.CameraConfig(**{**dict(eye=(0, 0, -4), projection="ortho",
                                          ortho_half_h=1.4), **cam}),
        render=JC.RenderConfig(width=128, height=64, steps=8, engine="warp",
                               warp_rect=64, density_scale=12.0))


def _four(eye, seed, **render):
    return JC.SceneConfig(
        n_particles=4, init="grid", seed=seed,
        volume=JC.VolumeConfig(size=16, bank_size=2, octaves=2),
        emitter=JC.EmitterConfig(radius=1.2, size_min=0.5, size_max=0.8,
                                 life_min=100.0, life_max=100.0),
        camera=JC.CameraConfig(eye=eye, look_at=(0, 0, 0), fov_y_deg=50.0),
        render=JC.RenderConfig(width=128, height=64, steps=8, engine="warp",
                               warp_rect=48, density_scale=10.0, **render))


def test_xla_matches_jax_and_oracle_persp(tiny_cfg):
    _, stats = _check(_warpify(tiny_cfg))
    assert int(stats["rendered"]) > 0


@pytest.mark.parametrize("lit", [False, True], ids=["unlit", "lit"])
def test_xla_matches_jax_and_oracle_ortho(lit):
    cfg = _ortho_cfg()
    if lit:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, light_steps=4))
    _check(cfg, lit=lit, alpha=0.1 if not lit else 0.05)


def test_xla_ortho_yawed_row_fan_and_clamps():
    """An ortho camera that is yawed and pitched: the constant-ratio row
    fan runs, and a shift max of one pixel clamps shifts, counted
    exactly."""
    cfg = _four((3.0, 1.0, -4.5), 9, warp_shift_max=1)
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, projection="ortho", ortho_half_h=1.6))
    assert tw.needs_row_fan(_port(cfg))
    _, stats = _check(cfg)
    assert int(stats["shift_clamped"]) > 0


def test_xla_backward_rays_match():
    """Camera looking along -z: every ray has dz < 0 (szn < 0, the back
    accumulators)."""
    _check(_four((0.2, 0.4, 5.0), 7))


def test_xla_yawed_camera_row_fan():
    cfg = _four((3.0, 1.0, -4.5), 9)
    assert tw.needs_row_fan(_port(cfg))
    _check(cfg)


@pytest.mark.parametrize("bank", [4, 80], ids=["onehot", "gather"])
def test_xla_onehot_and_gather_paths(tiny_cfg, bank):
    """bank_size 4 takes the one-hot product, above 64 the row gather."""
    cfg = tiny_cfg if bank == 4 else dataclasses.replace(
        tiny_cfg, volume=JC.VolumeConfig(size=8, bank_size=bank, octaves=1))
    assert (bank <= tx.ONEHOT_MAX_BANK) == (bank == 4)
    _check(_warpify(cfg))


def test_xla_lit_matches_oracle(tiny_lit_cfg):
    cfg = _warpify(tiny_lit_cfg)
    img, _ = _check(cfg, lit=True)
    unlit = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, light_steps=0))
    img_unlit, *_ = _render_both(unlit)
    assert img_unlit[..., :3].sum() > img[..., :3].sum()    # shadows


def test_xla_center_lit_matches_jax(tiny_lit_cfg):
    _check(_warpify(tiny_lit_cfg, light_mode="center"), lit=True)


def test_xla_light_volumes_with_zero_steps_renders_unlit(tiny_lit_cfg):
    """Light volumes with light_steps=0 change nothing."""
    cfg = _port(_warpify(tiny_lit_cfg))
    cfg0 = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, light_steps=0))
    state, camera, light = TL.setup(cfg, device="cpu")
    lv = TL._light_volumes(state, light, cfg)
    img_w, _ = render_frame(state.particles, state.volumes, camera, light,
                            cfg0, light_volumes=lv)
    img_n, _ = render_frame(state.particles, state.volumes, camera, light,
                            cfg0)
    assert torch.equal(img_w, img_n) and float(img_n[..., 3].max()) > 0.05


def test_xla_bf16_matches_quantized_oracle(tiny_cfg):
    _check(_warpify(tiny_cfg, warp_fp32=False, warp_canvas_fp32=False))


def test_xla_row_band_rendering(tiny_cfg):
    """Two half-height bands rendered separately give the full frame."""
    cfg = _port(_warpify(tiny_cfg))
    state, camera, light = TL.setup(cfg, device="cpu")
    full, _ = TL.render_only(state, camera, light, cfg)
    H = cfg.render.height
    top, _ = tw.render_warp(state.particles, state.volumes, camera, light,
                            cfg, y_start=0, h_local=H // 2)
    bot, _ = tw.render_warp(state.particles, state.volumes, camera, light,
                            cfg, y_start=H // 2, h_local=H // 2)
    assert float((torch.cat([top, bot]) - full).abs().max()) < 5e-6


def test_xla_megachunks_match_single_pass(tiny_cfg):
    """warp_mega=2 marches and composites four depth-ordered chunks onto
    one carried canvas: the single pass's image."""
    cfg = _port(_warpify(tiny_cfg))
    state, camera, light = TL.setup(cfg, device="cpu")
    one, _ = TL.render_only(state, camera, light, cfg)
    many, _ = TL.render_only(state, camera, light, dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, warp_mega=2)))
    assert float((one - many).abs().max()) < 1e-6


def test_xla_consistent_with_exact_renderer(tiny_cfg):
    cfg = _port(tiny_cfg)
    state, camera, light = TL.setup(cfg, device="cpu")
    exact, _ = TL.render_only(state, camera, light, cfg)
    warp, _ = TL.render_only(state, camera, light, _port(_warpify(tiny_cfg)))
    mse = float(((exact.double() - warp.double()) ** 2).mean())
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 30.0


@pytest.mark.parametrize("proj", ["persp", "ortho"])
def test_pallas_path_matches_xla_path(tiny_cfg, proj):
    """The port's Pallas path (kernels A and B, plain versions here) and
    its XLA path share semantics: within 1e-5 (tests/test_warp.py:233)."""
    cfg = _port(_warpify(tiny_cfg))
    if proj == "ortho":
        cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
            cfg.camera, projection="ortho", ortho_half_h=2.0))
    state, camera, light = TL.setup(cfg, device="cpu")
    img_x, st_x = TL.render_only(state, camera, light, cfg)
    img_p, st_p = TL.render_only(state, camera, light, dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, warp_pallas=True)))
    assert float(img_x[..., 3].max()) > 0.05
    assert float((img_x - img_p).abs().max()) < 1e-5
    for k in STATS:
        assert int(st_x[k]) == int(st_p[k]), k


def test_xla_path_bakes_no_slab_banks(tiny_cfg):
    """The XLA path streams the volumes: no slab banks are cached, nor
    baked by the animated re-bake; the frames loop renders."""
    cfg = _port(_warpify(tiny_cfg))
    state, camera, light = TL.setup(cfg, device="cpu")
    assert TL.cached_slab_banks(state, None, cfg) is None
    assert tw.bake_slab_banks(state.volumes, None, cfg) is None
    anim = dataclasses.replace(cfg, volume=dataclasses.replace(
        cfg.volume, animated=True))
    _, image, stats = TL.frames(state, camera, light, anim, n=2)
    assert float(image[..., 3].max()) > 0.05
    assert int(stats["rendered"][-1]) > 0
