"""volq_torch's exact engine (render/binning.py, render/exact.py and the
core ray / box / trilinear helpers) against the JAX package and the numpy
oracle, on the CPU.  Inputs go through both packages as numpy arrays.

Budgets: binning fields and stats equal (integers and booleans);
pixel_rays, ray_aabb and sample_bank_trilinear within 1e-6; the image
within 1e-5 of volq.render.render (XLA's jit contracts multiply-adds; the
port rounds op by op) and 1e-3 of render_oracle (the reference's budget).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volq.scene.config as JC
from volq.core.aabb import ray_aabb as j_ray_aabb
from volq.core.camera import pixel_rays as j_pixel_rays
from volq.core.interp import sample_bank_trilinear as j_sample
from volq.engine import loop as JL
from volq.oracle.raymarch_cpu import render_oracle
from volq.render.binning import bin_particles as j_bin
from volq.render.xla_render import render as j_render
import volq_torch.scene.config as TC
from volq_torch.convert import (state_from_numpy, camera_from_numpy,
                                light_from_numpy)
from volq_torch.core.aabb import ray_aabb
from volq_torch.core.camera import pixel_rays
from volq_torch.core.interp import sample_bank_trilinear
from volq_torch.engine import loop as TL
from volq_torch.render import render_frame
from volq_torch.render.binning import bin_particles
from volq_torch.render.exact import render

JAX_TOL = 1e-5
ORACLE_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These scenes are small: one intra-op thread is as fast, and does not
    fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(cfg):
    return TC.from_json(JC.to_json(cfg))


def _both(cfg):
    """The JAX package's set-up and the same state, camera and light in
    the port (carried across as numpy)."""
    state, camera, light = JL.setup(cfg)
    host = jax.device_get((state, camera, light))
    return (state, camera, light), (state_from_numpy(host[0], "cpu"),
                                    camera_from_numpy(host[1], "cpu"),
                                    light_from_numpy(host[2], "cpu"))


def _ortho_c1():
    c = JC.c1()
    return dataclasses.replace(
        c, volume=dataclasses.replace(c.volume, size=16, octaves=2),
        render=dataclasses.replace(c.render, width=128, height=64, steps=8,
                                   max_pairs=128))


def _assert_pairs_equal(ref, got):
    for f in ("pid", "tile", "valid", "seg_start", "count", "sort_idx",
              "cand_tile", "cand_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    assert set(got.stats) == set(ref.stats)
    for k, v in ref.stats.items():
        assert int(got.stats[k]) == int(v), k


@pytest.mark.parametrize("scene", ["tiny", "near_fade", "ortho"])
def test_bin_particles_equal(tiny_cfg, scene):
    cfg = {"tiny": tiny_cfg,
           "near_fade": dataclasses.replace(
               tiny_cfg, render=dataclasses.replace(
                   tiny_cfg.render, near_fade_start=5.5, near_fade_end=4.5)),
           "ortho": _ortho_c1()}[scene]
    (s, cam, _), (ts, tcam, _) = _both(cfg)
    got = bin_particles(ts.particles, tcam, _port(cfg))
    _assert_pairs_equal(j_bin(s.particles, cam, cfg), got)
    assert int(got.stats["pairs_kept"]) > 0
    if scene == "near_fade":
        assert int(got.stats["pairs_valid"]) < int(bin_particles(
            ts.particles, tcam, _port(tiny_cfg)).stats["pairs_valid"])


def test_bin_particles_caps_are_counted(tiny_cfg):
    """Budgets small enough that every cap drops something: the counts
    equal the reference's."""
    cfg = dataclasses.replace(tiny_cfg, render=dataclasses.replace(
        tiny_cfg.render, tile_w=32, max_tiles_per_particle=4, max_pairs=24,
        max_pairs_per_tile=1))
    (s, cam, _), (ts, tcam, _) = _both(cfg)
    got = bin_particles(ts.particles, tcam, _port(cfg))
    _assert_pairs_equal(j_bin(s.particles, cam, cfg), got)
    for k in ("mt_overflow", "cap_dropped", "rank_dropped"):
        assert int(got.stats[k]) > 0, k


def test_bin_particles_tile_range(tiny_cfg):
    """A local tile range equals the reference's, and the two halves
    concatenate to the full binning."""
    (s, cam, _), (ts, tcam, _) = _both(tiny_cfg)
    cfg = _port(tiny_cfg)
    r = cfg.render
    n_tiles = (r.width // r.tile_w) * (r.height // r.tile_h)
    half = n_tiles // 2
    full = bin_particles(ts.particles, tcam, cfg)
    lo = bin_particles(ts.particles, tcam, cfg, tile_start=0,
                       n_tiles_local=half)
    hi = bin_particles(ts.particles, tcam, cfg,
                       tile_start=torch.tensor(half),
                       n_tiles_local=n_tiles - half)
    _assert_pairs_equal(j_bin(s.particles, cam, tiny_cfg, tile_start=half,
                              n_tiles_local=n_tiles - half), hi)

    def kept(pairs, offset=0):
        v = pairs.valid
        return list(zip((pairs.tile[v] + offset).tolist(),
                        pairs.pid[v].tolist()))

    assert kept(lo) + kept(hi, offset=half) == kept(full)


@pytest.mark.parametrize("projection", ["persp", "ortho"])
def test_pixel_rays_and_ray_aabb(tiny_cfg, projection):
    cfg = dataclasses.replace(tiny_cfg, camera=dataclasses.replace(
        tiny_cfg.camera, projection=projection))
    (_, cam, _), (_, tcam, _) = _both(cfg)
    r = cfg.render
    py, px = np.meshgrid(np.arange(r.height, dtype=np.int32),
                         np.arange(r.width, dtype=np.int32), indexing="ij")
    o, d = j_pixel_rays(cam, jnp.asarray(px), jnp.asarray(py), r.width,
                        r.height, projection)
    to, td = pixel_rays(tcam, torch.from_numpy(px), torch.from_numpy(py),
                        r.width, r.height, projection)
    assert np.abs(np.asarray(o) - to.numpy()).max() <= 1e-6
    assert np.abs(np.asarray(d) - td.numpy()).max() <= 1e-6
    lo = np.array([-0.6, -0.4, -0.5], np.float32)
    hi = np.array([0.5, 0.7, 0.6], np.float32)
    # the same rays through both slab tests, one with a zero component
    o_np = np.array(o)
    d_np = np.array(d)
    d_np[0, 0] = (0.0, 0.0, 1.0)
    t0, t1 = j_ray_aabb(jnp.asarray(o_np), jnp.asarray(d_np),
                        jnp.asarray(lo), jnp.asarray(hi))
    tt0, tt1 = ray_aabb(torch.from_numpy(o_np), torch.from_numpy(d_np),
                        torch.from_numpy(lo), torch.from_numpy(hi))
    hit = np.asarray(t1 > t0)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(hit, (tt1 > tt0).numpy())
    assert np.abs(np.asarray(t0) - tt0.numpy())[hit].max() <= 1e-6
    assert np.abs(np.asarray(t1) - tt1.numpy())[hit].max() <= 1e-6


def test_sample_bank_trilinear():
    rng = np.random.default_rng(5)
    M, V, n = 3, 8, 500
    bank = rng.random((M, V, V, V), dtype=np.float32)
    vol = rng.integers(0, M, size=(n,), dtype=np.int32)
    # coordinates that also fall slightly outside the box
    u = (rng.random((n, 3), dtype=np.float32) * 1.2 - 0.1).astype(np.float32)
    ref = j_sample(jnp.asarray(bank, jnp.bfloat16).reshape(M, -1), V,
                   jnp.asarray(vol), jnp.asarray(u))
    tbank = torch.from_numpy(bank).to(torch.bfloat16).reshape(M, -1)
    got = sample_bank_trilinear(tbank, V, torch.from_numpy(vol),
                                torch.from_numpy(u))
    assert got.dtype == torch.float32
    assert np.abs(np.asarray(ref) - got.numpy()).max() <= 1e-6
    # grid points reproduce the stored values (z-major [V_z, V_x, V_y])
    x, y, z = 2, 5, 3
    at = torch.tensor([[x, y, z]], dtype=torch.float32) / (V - 1)
    v = sample_bank_trilinear(tbank, V, torch.tensor([1]), at)
    assert float(v) == float(tbank.reshape(M, V, V, V)[1, z, x, y])


def _render_both(cfg):
    (s, cam, li), (ts, tcam, tli) = _both(cfg)
    ref, ref_stats = jax.jit(j_render, static_argnames=("cfg",))(
        s.particles, s.volumes, cam, li, cfg=cfg)
    img, stats = render(ts.particles, ts.volumes, tcam, tli, _port(cfg))
    ref = np.asarray(ref)
    oracle = render_oracle(s.particles, s.volumes, cam, li, cfg)
    assert img.shape == ref.shape and img.dtype == torch.float32
    assert ref[..., 3].max() > 0.05
    d_jax = np.abs(img.numpy() - ref).max()
    d_oracle = np.abs(img.numpy().astype(np.float64) - oracle).max()
    assert d_jax <= JAX_TOL, d_jax
    assert d_oracle <= ORACLE_TOL, d_oracle
    for k, v in ref_stats.items():
        assert int(stats[k]) == int(v), k
    return img


@pytest.mark.parametrize("scene", ["tiny", "lit", "ortho_c1", "near_fade"])
def test_render_matches_jax_and_oracle(tiny_cfg, tiny_lit_cfg, scene):
    cfg = {"tiny": tiny_cfg, "lit": tiny_lit_cfg, "ortho_c1": _ortho_c1(),
           "near_fade": dataclasses.replace(
               tiny_cfg, render=dataclasses.replace(
                   tiny_cfg.render, near_fade_start=5.5, near_fade_end=4.5,
                   background=(0.1, 0.2, 0.3)))}[scene]
    img = _render_both(cfg)
    a = img[..., 3]
    assert bool(torch.isfinite(img).all())
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_lighting_darkens(tiny_cfg, tiny_lit_cfg):
    _, (ts, tcam, tli) = _both(tiny_lit_cfg)
    lit, _ = render(ts.particles, ts.volumes, tcam, tli, _port(tiny_lit_cfg))
    unlit, _ = render(ts.particles, ts.volumes, tcam, tli, _port(tiny_cfg))
    assert float(unlit[..., :3].sum()) > float(lit[..., :3].sum())
    assert torch.equal(unlit[..., 3], lit[..., 3])


def test_empty_scene_is_background():
    cfg = TC.SceneConfig(
        n_particles=4, init="empty",
        volume=TC.VolumeConfig(size=8, bank_size=1, octaves=1),
        render=TC.RenderConfig(width=128, height=16, steps=4, max_pairs=32,
                               max_pairs_per_tile=4,
                               background=(0.25, 0.5, 0.75)))
    state, camera, light = TL.setup(cfg, device="cpu")
    img, stats = TL.render_only(state, camera, light, cfg)
    assert np.allclose(img[..., :3].numpy(), [0.25, 0.5, 0.75], atol=1e-6)
    assert float(img[..., 3].abs().max()) == 0.0
    assert int(stats["alive"]) == 0 and int(stats["pairs_valid"]) == 0


def test_engine_dispatch(tiny_cfg):
    """render_frame takes the exact engine (both projections) and the
    warp engine (its XLA path, the default, and its Pallas path under an
    ortho camera) and still raises for the slab engine, naming the
    ROADMAP item."""
    cfg = _port(tiny_cfg)
    state, camera, light = TL.setup(cfg, device="cpu")
    img, _ = render_frame(state.particles, state.volumes, camera, light, cfg)
    ref, _ = render(state.particles, state.volumes, camera, light, cfg)
    assert torch.equal(img, ref)
    assert TL.cached_slab_banks(state, None, cfg) is None
    assert TL.cached_light_volumes(state, light, cfg) is None
    TL.setup(_port(_ortho_c1()), device="cpu")
    rep = dataclasses.replace
    slab = rep(cfg, render=rep(cfg.render, engine="slab"))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        render_frame(state.particles, state.volumes, camera, light, slab)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        TL.setup(slab, device="cpu")
    for good in (rep(cfg, render=rep(cfg.render, engine="warp")),
                 rep(cfg, camera=rep(cfg.camera, projection="ortho",
                                     ortho_half_h=2.0),
                     render=rep(cfg.render, engine="warp",
                                warp_pallas=True))):
        st, cam, li = TL.setup(good, device="cpu")
        img, stats = render_frame(st.particles, st.volumes, cam, li, good)
        assert tuple(img.shape) == (64, 128, 4)
        assert bool(torch.isfinite(img).all())
        assert float(img[..., 3].max()) > 0.05 and int(stats["rendered"]) > 0
        assert (TL.cached_slab_banks(st, None, good) is None) \
            == (not good.render.warp_pallas)
