"""volq_torch.render: the warp engine's slice (c3's render mode) against
the JAX package's fused Pallas path (interpret mode on the CPU) and the
numpy oracle, on tiny scenes carrying c3's render flags (march rect,
x-resampled slab banks, shift max), in bf16 (c3's mode) and fp32.

Budgets are the reference's own: fp32 within 1e-4 of JAX and 1e-3 of
the oracle (tests/test_warp.py:19); bf16 within 4/256 of both
(tests/test_warp.py:548).  Stats are exact.  On the CPU the kernel
wrappers run their plain PyTorch versions.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import volq.scene.config as JC
from volq.engine.loop import setup, render_only
from volq.oracle.warp_cpu import render_warp_oracle
from volq.render import warp as jw
import volq_torch.scene.config as TC
from volq_torch.convert import (state_from_numpy, camera_from_numpy,
                                light_from_numpy)
from volq_torch import _build
from volq_torch.engine import loop as TL
from volq_torch.render import kernel as K
from volq_torch.render import warp as tw

STATS = ("alive", "rendered", "straddled", "rect_overflow", "shift_clamped")


def c3_flags(cfg, fp32=False, **kw):
    """A tiny scene with c3's render mode (fused Pallas warp, unlit,
    RM < RP, x-resampled slab banks, K = 6)."""
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, engine="warp", warp_pallas=True, warp_rect=48,
        warp_march_rect=32, warp_slab_vx=8, warp_shift_max=6,
        warp_fp32=fp32, warp_canvas_fp32=fp32, **kw))


def _port(cfg):
    return TC.from_json(JC.to_json(cfg))


def _scene(cfg):
    state, camera, light = setup(cfg)
    return (state, camera, light,
            state_from_numpy(jax.device_get(state), "cpu"),
            camera_from_numpy(camera, "cpu"), light_from_numpy(light, "cpu"))


def _tiny_cameras(tiny_cfg):
    """tiny_cfg's yawed camera (row fan on), a c3-like pitched camera
    (row fan off) and a side view marching along world x."""
    pitched = dataclasses.replace(tiny_cfg, camera=JC.CameraConfig(
        eye=(0.0, 1.0, -5.5), look_at=(0.0, 0.2, 0.0), fov_y_deg=45.0))
    side = JC.SceneConfig(
        n_particles=4, init="grid", seed=7,
        volume=JC.VolumeConfig(size=16, bank_size=2, octaves=2),
        emitter=JC.EmitterConfig(radius=1.2, size_min=0.5, size_max=0.8,
                                 life_min=100.0, life_max=100.0),
        camera=JC.CameraConfig(eye=(5.2, 0.6, 0.4), look_at=(0, 0, 0),
                               fov_y_deg=50.0),
        render=JC.RenderConfig(width=128, height=64, steps=8,
                               density_scale=10.0))
    return {"yawed": tiny_cfg, "pitched": pitched, "side": side}


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("view", ["yawed", "pitched", "side"])
def test_render_warp_matches_jax_and_oracle(tiny_cfg, view, fp32):
    cfg = c3_flags(_tiny_cameras(tiny_cfg)[view], fp32)
    row_fan = {"yawed": True, "pitched": False}.get(view)
    if row_fan is not None:
        assert jw.needs_row_fan(cfg) == row_fan == tw.needs_row_fan(cfg)
    if view == "side":
        assert jw._march_perm(cfg)[0] != (0, 1, 2)
    st, cam, li, tst, tcam, tli = _scene(cfg)
    ref, ref_stats = render_only(st, cam, li, cfg)
    ref = np.asarray(ref, np.float64)
    oracle = render_warp_oracle(st.particles, st.volumes, cam, li, cfg)
    img, stats = tw.render_warp(tst.particles, tst.volumes, tcam, tli,
                                _port(cfg))
    img = img.numpy().astype(np.float64)
    assert img.shape == ref.shape and img[..., 3].max() > 0.05
    tol_jax, tol_oracle = (1e-4, 1e-3) if fp32 else (4 / 256, 4 / 256)
    assert np.abs(img - ref).max() <= tol_jax
    assert np.abs(img - oracle).max() <= tol_oracle
    for k in STATS:
        assert int(stats[k]) == int(ref_stats[k]), k


def test_render_warp_near_fade_and_culling(tiny_cfg):
    """c3's camera-proximity fade culls and fades particles; the stats and
    image follow the reference."""
    cfg = c3_flags(tiny_cfg, near_fade_start=5.3, near_fade_end=4.6)
    st, cam, li, tst, tcam, tli = _scene(cfg)
    ref, ref_stats = render_only(st, cam, li, cfg)
    img, stats = tw.render_warp(tst.particles, tst.volumes, tcam, tli,
                                _port(cfg))
    assert 0 < int(ref_stats["rendered"]) < int(ref_stats["alive"])
    for k in STATS:
        assert int(stats[k]) == int(ref_stats[k]), k
    assert np.abs(img.numpy() - np.asarray(ref)).max() <= 4 / 256


@pytest.mark.parametrize("vx", [0, 8])
@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
def test_bake_march_slabs_matches(vx, fp32):
    """Pre-lerped (and x-resampled) slab banks against the reference's
    jitted bake: XLA fuses the lerp's multiply-add, so values may differ
    by one rounding of the working type."""
    rng = np.random.default_rng(4)
    vol = rng.random((3, 16, 16, 16), dtype=np.float32)
    import jax.numpy as jnp
    jdt, tdt = ((jnp.float32, torch.float32) if fp32
                else (jnp.bfloat16, torch.bfloat16))
    ref = np.asarray(jax.jit(lambda v: jw.bake_march_slabs(
        v, 8, jdt, vx))(jnp.asarray(vol, jnp.bfloat16)).astype(jnp.float32))
    got = tw.bake_march_slabs(torch.from_numpy(vol).to(torch.bfloat16), 8,
                              tdt, vx).float().numpy()
    assert ref.shape == got.shape == (3, 8, vx or 16, 16)
    ulp = 2.0 ** -23 if fp32 else 2.0 ** -8
    assert np.abs(ref - got).max() <= ulp
    assert jw._march_z_consts(8, 16) == tw._march_z_consts(8, 16)
    assert jw._slab_x_consts(8, 16) == tw._slab_x_consts(8, 16)


@pytest.mark.parametrize("view", ["yawed", "side"])
def test_grid_geometry_matches(tiny_cfg, view):
    cfg = c3_flags(_tiny_cameras(tiny_cfg)[view])
    st, cam, li, tst, tcam, tli = _scene(cfg)
    jp, _, jc, _ = jw.permute_for_march(st.particles, st.volumes, cam,
                                        None, cfg)
    ref, ref_stats = jax.jit(jw._grid_geometry, static_argnums=(2, 3, 4))(
        jp, jc, cfg, 0, 64)
    tp, tc = tw.permute_for_march(tst.particles, tcam, _port(cfg))
    got, stats = tw._grid_geometry(tp, tc, _port(cfg), 0, 64)
    for k in ("sx0", "sy0", "valid", "szn"):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy())
    for k in ("px_c", "py_c", "vz", "scale", "rx_u", "ry_w", "foot_w",
              "foot_h"):
        a, b = np.asarray(ref[k]), got[k].numpy()
        assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(a).max()), k
    for k in ref_stats:
        assert int(stats[k]) == int(ref_stats[k]), k


FLAGS = [
    dict(engine="slab"),
    dict(warp_pallas=False),
    dict(light_steps=4, light_mode="march"),
    dict(warp_coarse=1),
    dict(warp_canvas_scale=0.8),
    dict(warp_interleave=1),
    dict(warp_canvas_vmem=1),
    dict(warp_bands=2),
    dict(warp_hazard_passes=1),
]


@pytest.mark.parametrize("kw", FLAGS, ids=lambda kw: ",".join(kw))
def test_flags_outside_the_slice_raise(tiny_cfg, kw):
    """No flag lies outside the port any more: each of these (the slab
    engine among them) renders a finite frame through the loop under
    both projections.  Their images are held to the reference
    elsewhere (the slab engine: tests/test_torch_slab.py; the XLA warp
    path: test_torch_warp_xla.py; the rest: test_torch_warp_c5.py,
    test_torch_perstep.py)."""
    base = c3_flags(tiny_cfg)
    cfg = _port(dataclasses.replace(
        base, render=dataclasses.replace(base.render, **kw)))
    ortho = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, projection="ortho", ortho_half_h=2.0))
    for c in (cfg, ortho):
        st, cam, li = TL.setup(c, device="cpu")
        img, stats = TL.render_only(st, cam, li, c)
        assert tuple(img.shape) == (64, 128, 4)
        assert bool(torch.isfinite(img).all())
        assert float(img[..., 3].max()) > 0.05 and int(stats["alive"]) > 0


def test_ortho_and_animated_raise(tiny_cfg):
    """An ortho camera renders through the Pallas path's kernels (their
    plain versions here: A and B in their orthographic mode), as do
    animated volumes, alone and with every flag that joined the port
    with them."""
    base = _port(c3_flags(tiny_cfg))
    ortho = dataclasses.replace(base, camera=dataclasses.replace(
        base.camera, projection="ortho", ortho_half_h=2.0))
    st, cam, li, tst, tcam, tli = _scene(c3_flags(tiny_cfg))
    from volq_torch.scene.state import build_camera
    ocam = build_camera(ortho.camera, 128, 64, "cpu")
    img, stats = tw.render_warp(tst.particles, tst.volumes, ocam, tli, ortho)
    assert tuple(img.shape) == (64, 128, 4)
    assert bool(torch.isfinite(img).all()) and float(img[..., 3].max()) > 0.05
    assert int(stats["rendered"]) > 0 and int(stats["straddled"]) == 0
    animated = dataclasses.replace(base, volume=dataclasses.replace(
        base.volume, animated=True))
    for c in (animated, dataclasses.replace(
            animated, render=dataclasses.replace(
                animated.render, warp_coarse=1, warp_interleave=1,
                warp_bands=2, warp_canvas_vmem=1, warp_hazard_passes=1,
                light_steps=4))):
        s, cam_, li_ = TL.setup(c, device="cpu")
        s, img, stats = TL.frame(s, cam_, li_, c)
        assert bool(torch.isfinite(img).all())
        assert float(img[..., 3].max()) > 0.05 and int(stats["rendered"]) > 0


@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("steps", [16, 20])
def test_steps_at_least_V_match_jax_and_oracle(tiny_cfg, steps, fp32):
    """With steps >= V the reference streams the volumes and lerps in the
    kernel (``use_slab_banks`` False); the port marches its slab banks,
    the same lerp with the same rounding points.  What differs is XLA's
    jit of the interpreted kernel: it contracts ``lo_z + zeta*ext`` into
    a multiply-add and, for S = 20, divides ``(s + 0.5) / S`` as a
    reciprocal multiply.  bf16 is held to one bf16 ulp of the canvas's
    largest values (2^-8, the spacing in [0.5, 1) where T and alpha
    live) against the JAX Pallas path -- a flipped rounding of C or T
    moves a pixel by that much at most --, fp32 to the file's 1e-4, and
    both to the oracle's budgets."""
    cfg = dataclasses.replace(tiny_cfg, render=dataclasses.replace(
        tiny_cfg.render, engine="warp", warp_pallas=True, warp_rect=48,
        steps=steps, warp_fp32=fp32, warp_canvas_fp32=fp32))
    assert not jw.use_slab_banks(cfg, 16) and not tw.use_slab_banks(
        _port(cfg), 16)
    st, cam, li, tst, tcam, tli = _scene(cfg)
    ref, ref_stats = render_only(st, cam, li, cfg)
    ref = np.asarray(ref, np.float64)
    oracle = render_warp_oracle(st.particles, st.volumes, cam, li, cfg)
    img, stats = tw.render_warp(tst.particles, tst.volumes, tcam, tli,
                                _port(cfg))
    img = img.numpy().astype(np.float64)
    assert img[..., 3].max() > 0.05
    if fp32:
        assert np.abs(img - ref).max() <= 1e-4
        assert np.abs(img - oracle).max() <= 1e-3
    else:
        assert np.abs(img - ref).max() <= 2.0 ** -8
        assert np.abs(img - oracle).max() <= 4 / 256
    for k in STATS:
        assert int(stats[k]) == int(ref_stats[k]), k


def test_kernel_wrappers_on_cpu_run_plain_and_count_nothing(tiny_cfg):
    cfg = _port(c3_flags(tiny_cfg))
    st, cam, li, tst, tcam, tli = _scene(c3_flags(tiny_cfg))
    bank = tw.bake_slab_banks(tst.volumes, None, cfg)[0]
    march, comp, _ = tw.fused_inputs(tst.particles, tcam, tli, cfg, bank,
                                     0, 64)
    n0 = _build.launches.copy()
    P2m, clamp = K.warp_march(*march)
    ref_p2, ref_clamp = K.warp_march_plain(*march)
    assert torch.equal(P2m, ref_p2) and torch.equal(clamp, ref_clamp)
    canvas = K.canvas_init(cfg, 64, "cpu")
    out = K.warp_composite(canvas.clone(), P2m, *comp)
    assert torch.equal(out, K.warp_composite_plain(canvas.clone(), P2m,
                                                   *comp))
    assert _build.launches == n0
    with pytest.raises(TypeError):
        K.warp_march(march[0], march[1].long(), *march[2:])
    with pytest.raises(ValueError):
        K.warp_composite(canvas[:, :-1], P2m, *comp)
