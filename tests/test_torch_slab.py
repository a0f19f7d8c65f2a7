"""volq_torch's slab engine (render/slab.py) against the JAX package's
(volq.render.slab, jitted on the CPU) and the slab oracle
(volq.oracle.slab_cpu), on the cases of tests/test_slab.py.  Both
packages render one SceneState, carried across as numpy, and one baked
light volume.

Budgets: fp32 within 1e-5 of JAX (XLA's jit contracts multiply-adds, the
port rounds op by op); 1e-3 of the oracle in fp32 and bf16 (the
reference's budget); ``slab_grouped`` frames within 1e-5 of the
pairwise ones and of the reference's grouped march (the port marches
pairwise either way: render/slab.py says why); chunk sizes, bank routes
and tile ranges equal (torch.equal); PSNR > 30 dB against the exact engine (the reference's).
In bf16 the port is held to the oracle only: XLA contracts ``ox + ts *
dx`` into a multiply-add, which moves a hat weight across a bf16 rounding
boundary at a few pixels.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import volq.scene.config as JC
from volq.engine import loop as JL
from volq.oracle.raymarch_cpu import render_oracle
from volq.oracle.slab_cpu import render_slab_oracle
from volq.render import render_frame as j_render_frame
import volq_torch.scene.config as TC
from volq_torch.convert import (state_from_numpy, camera_from_numpy,
                                light_from_numpy, light_volumes_from_numpy)
from volq_torch.engine import loop as TL
from volq_torch.render import render_frame, render_frame_tiles
from volq_torch.render import slab as TS
from volq_torch.render.slab_oracle import render_slab_oracle as t_oracle

JAX_TOL = 1e-5
ORACLE_TOL = 1e-3
rep = dataclasses.replace
_j_render = jax.jit(j_render_frame, static_argnames=("cfg",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These scenes are small: one intra-op thread is as fast, and does not
    fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slab(cfg, **kw):
    return rep(cfg, render=rep(cfg.render, engine="slab", **kw))


def _port(cfg):
    return TC.from_json(JC.to_json(cfg))


class _Scene:
    """One JAX set-up, the same state / camera / light / light volume in
    the port, and the oracle's frame."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.j = JL.setup(cfg)
        self.jlv = JL._light_volumes(self.j[0], self.j[2], cfg)
        self.lv = None if self.jlv is None else np.asarray(self.jlv)
        host = jax.device_get(self.j)
        self.t = (state_from_numpy(host[0], "cpu"),
                  camera_from_numpy(host[1], "cpu"),
                  light_from_numpy(host[2], "cpu"))
        self.tlv = (None if self.lv is None
                    else light_volumes_from_numpy(self.lv, "cpu"))

    def jax(self, cfg=None):
        st, cam, li = self.j
        img, stats = _j_render(st.particles, st.volumes, cam, li,
                               cfg=cfg or self.cfg, light_volumes=self.jlv)
        return np.asarray(img, np.float64), stats

    def port(self, cfg=None, volumes=None):
        st, cam, li = self.t
        return render_frame(st.particles,
                            st.volumes if volumes is None else volumes,
                            cam, li, _port(cfg or self.cfg),
                            light_volumes=self.tlv)

    def oracle(self, cfg=None):
        st, cam, li = self.j
        return render_slab_oracle(st.particles, st.volumes, cam, li,
                                  cfg or self.cfg, light_volumes=self.lv)


def _check(cfg, jax_tol=JAX_TOL, min_alpha=0.05):
    """Port against JAX (``jax_tol``; None: not held) and the oracle;
    stats equal.  Returns (scene, port image)."""
    sc = _Scene(cfg)
    img, stats = sc.port()
    assert tuple(img.shape) == (cfg.render.height, cfg.render.width, 4)
    assert float(img[..., 3].max()) > min_alpha
    got = img.numpy().astype(np.float64)
    ref, ref_stats = sc.jax()
    if jax_tol is not None:
        assert np.abs(got - ref).max() <= jax_tol
    assert np.abs(got - sc.oracle()).max() < ORACLE_TOL
    assert {k: int(v) for k, v in stats.items()} \
        == {k: int(v) for k, v in ref_stats.items()}
    return sc, img


def test_slab_persp(tiny_cfg):
    _check(_slab(tiny_cfg))


def test_slab_ortho():
    cfg = JC.SceneConfig(
        n_particles=1, init="single", seed=1,
        volume=JC.VolumeConfig(size=16, bank_size=1, octaves=2),
        emitter=JC.EmitterConfig(size_min=1.0, size_max=1.0,
                                 life_min=100.0, life_max=100.0),
        camera=JC.CameraConfig(eye=(0, 0, -4), projection="ortho",
                               ortho_half_h=1.4),
        render=JC.RenderConfig(width=128, height=64, steps=8, engine="slab",
                               max_pairs=128, max_pairs_per_tile=4,
                               density_scale=12.0))
    _check(cfg, min_alpha=0.1)


def test_slab_backward_rays():
    """A camera looking along -z: every ray has dz < 0 and takes the
    back-to-front accumulator."""
    cfg = JC.SceneConfig(
        n_particles=4, init="grid", seed=7,
        volume=JC.VolumeConfig(size=16, bank_size=2, octaves=2),
        emitter=JC.EmitterConfig(radius=1.2, size_min=0.5, size_max=0.8,
                                 life_min=100.0, life_max=100.0),
        camera=JC.CameraConfig(eye=(0.2, 0.4, 5.0), look_at=(0, 0, 0)),
        render=JC.RenderConfig(width=128, height=64, steps=8, engine="slab",
                               max_pairs=128, max_pairs_per_tile=8,
                               density_scale=10.0))
    _check(cfg)


def test_slab_onehot_and_gather_banks(tiny_cfg):
    """The reference's one-hot route (bank 4) and row gather (bank 80)."""
    big = rep(tiny_cfg, n_particles=8,
              volume=JC.VolumeConfig(size=8, bank_size=80, octaves=1))
    for cfg in (_slab(tiny_cfg), _slab(big)):
        _check(cfg)


def test_slab_bank_routes_equal(tiny_cfg):
    """The reference picks its fetch route by bank size (shared, one-hot
    up to ONEHOT_MAX_BANK, row gather); here one bank entry gives the
    same image whether the bank holds it alone or among 4 or 80
    entries."""
    cfg = rep(_slab(tiny_cfg, slab_window=10, light_steps=4),
              volume=rep(tiny_cfg.volume, bank_size=1))
    sc = _Scene(cfg)
    img, _ = sc.port()
    vol = sc.t[0].volumes
    for m in (4, TS.ONEHOT_MAX_BANK + 16):
        noise = torch.rand((m - 1,) + tuple(vol.shape[1:])).to(vol.dtype)
        img_m, _ = sc.port(volumes=torch.cat([vol, noise]))
        assert torch.equal(img, img_m), m
    assert np.abs(img.numpy() - sc.jax()[0]).max() <= JAX_TOL


def test_slab_lit(tiny_lit_cfg):
    cfg = _slab(tiny_lit_cfg)
    sc, img = _check(cfg)
    # shadows darken the unlit slab render
    st, cam, li = sc.t
    unlit, _ = render_frame(st.particles, st.volumes, cam, li,
                            _port(rep(cfg, render=rep(cfg.render,
                                                      light_steps=0))))
    assert float(unlit[..., :3].sum()) > float(img[..., :3].sum())


def test_slab_windowed(tiny_cfg):
    """slab_window < V: the window is part of the sampling spec."""
    _check(_slab(tiny_cfg, slab_window=10))


def test_slab_bf16_matches_quantized_oracle(tiny_cfg):
    """slab_fp32=False: bf16 slabs and hat weights, as the oracle's
    quantized mode rounds them."""
    _check(_slab(tiny_cfg, slab_fp32=False, slab_window=12), jax_tol=None)
    _check(_slab(tiny_cfg, slab_fp32=False), jax_tol=None)


def test_slab_grouped_matches_pairwise(tiny_cfg):
    """slab_grouped is an execution strategy: the port's frame under it
    is held to the reference's grouped march and the oracle, and stays
    within 1e-5 of the pairwise frame."""
    base = _slab(tiny_cfg, slab_window=10)
    grouped = rep(base, render=rep(base.render, slab_grouped=True,
                                   slab_particle_chunk=4))
    sc, img_g = _check(grouped)
    img_p, _ = sc.port(base)
    assert float((img_p - img_g).abs().max()) <= 1e-5


def test_slab_chunks_and_tile_ranges_equal(tiny_cfg):
    """slab_pair_chunk / slab_particle_chunk bound memory only; a frame
    rendered as flat tile ranges (render_frame_tiles, the sharded
    frame's unit) is the whole frame."""
    cfg = _slab(tiny_cfg, slab_window=10)
    sc = _Scene(cfg)
    img, _ = sc.port()
    for kw in (dict(slab_pair_chunk=0), dict(slab_pair_chunk=48),
               dict(slab_pair_chunk=100), dict(slab_pair_chunk=1 << 20)):
        assert torch.equal(img, sc.port(rep(cfg, render=rep(cfg.render,
                                                            **kw)))[0]), kw
    g = rep(cfg, render=rep(cfg.render, slab_grouped=True))
    img_g, _ = sc.port(g)
    for chunk in (1, 3, 8):
        assert torch.equal(img_g, sc.port(rep(g, render=rep(
            g.render, slab_particle_chunk=chunk)))[0]), chunk
    st, cam, li = sc.t
    r = cfg.render
    n_tiles = (r.width // r.tile_w) * (r.height // r.tile_h)
    for c in (_port(cfg), _port(g), _port(rep(cfg, render=rep(
            cfg.render, engine="exact")))):
        whole, _ = render_frame_tiles(st.particles, st.volumes, cam, li, c)
        parts = [render_frame_tiles(st.particles, st.volumes, cam, li, c,
                                    tile_start=t0, n_tiles_local=3)[0]
                 for t0 in range(0, n_tiles, 3)]
        assert torch.equal(torch.cat(parts)[:n_tiles], whole)


def test_slab_grouped_lit_large_bank(tiny_cfg):
    """slab_grouped over an 80-entry bank (the reference's row gather in
    its grouped march), lit."""
    cfg = rep(tiny_cfg, n_particles=8,
              volume=JC.VolumeConfig(size=8, bank_size=80, octaves=1),
              render=rep(tiny_cfg.render, engine="slab", slab_grouped=True,
                         light_steps=4, slab_particle_chunk=4))
    _check(cfg)


def test_slab_consistent_with_exact_engine(tiny_cfg):
    """Another quadrature of the same scene: PSNR > 30 dB."""
    state, camera, light = TL.setup(_port(tiny_cfg), device="cpu")
    img_e, _ = TL.render_only(state, camera, light, _port(tiny_cfg))
    img_s, _ = TL.render_only(state, camera, light,
                              _port(_slab(tiny_cfg)))
    mse = float(((img_e.double() - img_s.double()) ** 2).mean())
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 30.0


def test_slab_near_fade(tiny_cfg):
    """Camera-proximity fade: partly faded and culled particles agree;
    the exact engine under the same fade agrees with its oracle."""
    cfg = _slab(tiny_cfg, near_fade_start=5.2, near_fade_end=4.2)
    sc, _ = _check(cfg, min_alpha=0.01)
    cfg_e = rep(cfg, render=rep(cfg.render, engine="exact"))
    st, cam, li = sc.t
    img_e, _ = render_frame(st.particles, st.volumes, cam, li, _port(cfg_e))
    js, jc, jl = sc.j
    ref = render_oracle(js.particles, js.volumes, jc, jl, cfg_e)
    assert np.abs(img_e.numpy() - ref).max() < ORACLE_TOL


def test_oracle_copy_equals_reference(tiny_lit_cfg):
    """The port's copy of the slab oracle (render/slab_oracle.py, what
    chip_smoke.py holds the card to) is the reference's, bit for bit, in
    bf16 with a window and lighting, and on a pixel window."""
    cfg = _slab(tiny_lit_cfg, slab_fp32=False, slab_window=12)
    sc = _Scene(cfg)
    st, cam, li = jax.device_get(sc.j)
    for window in (None, (40, 8, 48, 32)):
        ref = render_slab_oracle(st.particles, st.volumes, cam, li, cfg,
                                 window=window, light_volumes=sc.lv)
        got = t_oracle(st.particles, st.volumes, cam, li, cfg,
                       window=window, light_volumes=sc.lv)
        assert np.array_equal(ref, got) and ref[..., 3].max() > 0.05
