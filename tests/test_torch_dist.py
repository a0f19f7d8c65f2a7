"""volq_torch's sharded frame (dist/) over gloo, 2, 4 and 8 CPU processes,
against the port's single-process frame: the cases of tests/test_dist.py
(plain frame, animated re-bake, warp binary swap lit, emission across
shard boundaries, the bf16 wire, coarse + interleave) and the slab
engine, lit.  The image within 1e-5, the particle state within 1e-6,
``alive`` and ``pairs_kept`` equal (the reference's budgets); the bf16
wire within 40 dB PSNR and bf16 on the wire.

The exact and the warp case are also held against the JAX package's
sharded frame on conftest's 8 virtual CPU devices, at the budgets the
port's single-device tests of the same configs use:
tests/test_torch_exact.py::test_render_matches_jax_and_oracle (image
1e-5), tests/test_torch_warp_xla.py::test_xla_lit_matches_oracle (the
warp engine's XLA path, lit: 1e-5), tests/test_torch_loop.py::
test_frames_match_reference (particle state after 3 frames: 1e-5).

Every mesh size runs all seven cases in one set of rank processes
(``engine.loop.run_sharded``); the rank processes import the port only.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import volq.scene.config as JC
from volq.dist.mesh import make_mesh as j_make_mesh
from volq.dist.sharded import sharded_frame_fn as j_sharded_frame_fn
from volq.dist.sharded import shard_state as j_shard_state
from volq.engine.loop import setup as j_setup
import volq_torch.scene.config as TC
from volq_torch.cli import main
from volq_torch.convert import state_to_numpy
from volq_torch.dist import make_mesh, sharded_frame_fn
from volq_torch.engine import loop as TL

TOL = 1e-5
STATE_TOL = 1e-6
JAX_STATE_TOL = 1e-5
SIZES = [2, 4, 8]
rep = dataclasses.replace


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


def _cases(tiny):
    """name -> (JAX config, frames, frames per call): tests/test_dist.py's
    scenes."""
    emit = rep(tiny.emitter, rate=30.0, life_min=0.4, life_max=0.8)
    warp = dict(engine="warp", warp_rect=48, warp_chunk=4)
    return {
        "plain": (rep(tiny, n_particles=16, emitter=emit), 3, 1),
        "animated": (rep(tiny, n_particles=16, volume=JC.VolumeConfig(
            size=8, bank_size=8, octaves=1, animated=True),
            emitter=rep(tiny.emitter, rate=30.0)), 2, 2),
        "warp_lit": (rep(tiny, n_particles=16, emitter=emit, render=rep(
            tiny.render, light_steps=4, **warp)), 3, 1),
        "emission": (rep(tiny, n_particles=32, init="empty",
                         emitter=rep(tiny.emitter, rate=150.0,
                                     life_min=0.2, life_max=0.3)), 5, 1),
        "bf16_wire": (rep(tiny, n_particles=16, emitter=emit, render=rep(
            tiny.render, light_steps=4, warp_swap_bf16=1, **warp)), 2, 1),
        "slab_lit": (rep(tiny, n_particles=16, emitter=emit, render=rep(
            tiny.render, engine="slab", light_steps=4, slab_window=10,
            slab_grouped=True, slab_particle_chunk=4)), 3, 1),
        "coarse_ilv": (rep(tiny, n_particles=16, emitter=emit, render=rep(
            tiny.render, warp_pallas=True, warp_fused=True,
            warp_march_rect=32, warp_shift_max=8, warp_coarse=1,
            warp_interleave=1, **warp)), 3, 1),
    }


@pytest.fixture(scope="module")
def runs(tiny_cfg):
    """Lazily, per mesh size: the sharded records of every case, and
    per case the single-process frames."""
    cases = _cases(tiny_cfg)
    sharded, single = {}, {}

    def get(name, size):
        if size not in sharded:
            recs = TL.run_sharded(make_mesh(size, "cpu"),
                                  [(_port(c), n, k)
                                   for c, n, k in cases.values()])
            sharded[size] = dict(zip(cases, recs))
        if name not in single:
            cfg, n, _ = cases[name]
            cfg = _port(cfg)
            st, cam, li = TL.setup(cfg, device="cpu")
            lv = TL.cached_light_volumes(st, li, cfg)
            sb = TL.cached_slab_banks(st, lv, cfg)
            for _ in range(n):
                st, img, stats = TL.frame(st, cam, li, cfg, lv, sb)
            single[name] = (state_to_numpy(st), img.numpy(),
                            {k: int(v) for k, v in stats.items()})
        return sharded[size][name], single[name]

    get.cases = cases
    return get


def _compare(runs, name, size, tol=TOL):
    rec, (state, img, stats) = runs(name, size)
    assert rec["image"].shape == img.shape and img[..., 3].max() > 0.05
    assert np.abs(rec["image"].astype(np.float64) - img).max() < tol
    for f in state.particles._fields:
        a = np.asarray(getattr(state.particles, f), np.float64)
        b = np.asarray(getattr(rec["state"].particles, f), np.float64)
        assert np.abs(a - b).max() <= STATE_TOL, f
    for f in ("frame", "spawn_carry", "time"):
        assert getattr(state, f) == getattr(rec["state"], f), f
    for k in ("alive", "pairs_kept"):
        if k in stats:
            assert rec["stats"][k] == stats[k], k
    return rec


@pytest.mark.slow
@pytest.mark.parametrize("size", SIZES)
def test_sharded_frame_matches_single_device(runs, size):
    _compare(runs, "plain", size)


@pytest.mark.parametrize("size", SIZES)
def test_sharded_animated_rebake(runs, size):
    """Animated bank, baked over bank entries split across the ranks
    (bank 8 divides by 2, 4 and 8), two frames in one call."""
    _compare(runs, "animated", size)


@pytest.mark.parametrize("size", SIZES)
def test_sharded_warp_binary_swap_matches_single_device(runs, size):
    """Depth slices marched per rank, combined by binary swap, lit."""
    rec = _compare(runs, "warp_lit", size)
    assert set(rec["wire"]) == {"torch.float32"}


@pytest.mark.parametrize("size", SIZES)
def test_sharded_emission_matches_global_order(runs, size):
    """Most slots dead: the spawn budget crosses shard boundaries."""
    _compare(runs, "emission", size)


@pytest.mark.parametrize("size", SIZES)
def test_sharded_slab_matches_single_device(runs, size):
    """The slab engine's tile ranges (slab_grouped set, windowed, lit):
    the light bank baked on every rank."""
    _compare(runs, "slab_lit", size)


@pytest.mark.parametrize("size", SIZES)
def test_sharded_swap_bf16_wire(runs, size):
    """warp_swap_bf16: every payload handed to the wire is bf16, half the
    bytes of the fp32 wire on the same canvas, and the frame stays within
    a bf16 quantization band of the single-process one (PSNR >= 40)."""
    rec, (_, img, _) = runs("bf16_wire", size)
    a, b = img.astype(np.float64), rec["image"].astype(np.float64)
    mse = np.mean((a - b) ** 2)
    psnr = 10 * np.log10(a.max() ** 2 / mse) if mse else np.inf
    assert psnr >= 40.0, f"bf16 wire PSNR {psnr:.1f} dB"
    assert set(rec["wire"]) == {"torch.bfloat16"}
    fp32, _ = runs("warp_lit", size)
    per_frame = rec["wire"]["torch.bfloat16"] / 2
    assert per_frame * 2 == fp32["wire"]["torch.float32"] / 3 > 0


@pytest.mark.slow
@pytest.mark.parametrize("size", SIZES)
def test_sharded_coarse_interleave_matches_single_device(runs, size):
    """The cell canvas of warp_coarse, interleaved, rides the swap; the
    cell -> pixel upsample runs once, after the merge."""
    _compare(runs, "coarse_ilv", size)


@pytest.mark.parametrize("name", ["plain", "warp_lit"])
def test_sharded_matches_jax_sharded_frame(runs, name):
    """The port's 8-rank frame against volq.dist on 8 virtual devices."""
    cfg, n, _ = runs.cases[name]
    mesh = j_make_mesh(8)
    _, camera, light = j_setup(cfg)
    state = j_shard_state(j_setup(cfg)[0], mesh)
    frame = j_sharded_frame_fn(cfg, mesh)
    for _ in range(n):
        state, img, stats = frame(state, camera, light)
    rec, _ = runs(name, 8)
    img = np.asarray(img, np.float64)
    assert img[..., 3].max() > 0.05
    assert np.abs(rec["image"] - img).max() <= TOL
    ref = jax.device_get(state)
    for f in ref.particles._fields:
        a = np.asarray(getattr(ref.particles, f), np.float64)
        b = np.asarray(getattr(rec["state"].particles, f), np.float64)
        assert np.abs(a - b).max() <= JAX_STATE_TOL, f
    for k in ("alive", "pairs_kept"):
        if k in stats:
            assert rec["stats"][k] == int(stats[k]), k


def test_sharded_preconditions_and_mesh_device_check(tiny_cfg, monkeypatch):
    """The reference's ValueErrors, and a mesh on the card needs a card
    per rank: it never carries on over gloo on the CPU."""
    cfg = _port(rep(tiny_cfg, n_particles=12))
    warp = rep(cfg, render=rep(cfg.render, engine="warp"))
    with pytest.raises(ValueError, match="n_particles 12 must divide by "
                       "mesh size 8"):
        sharded_frame_fn(cfg, make_mesh(8, "cpu"))
    with pytest.raises(ValueError, match="mesh size 6 must be a power of "
                       "two"):
        sharded_frame_fn(warp, make_mesh(6, "cpu"))
    with pytest.raises(ValueError, match="requires warp_canvas_fp32=True"):
        sharded_frame_fn(rep(warp, render=rep(
            warp.render, warp_canvas_fp32=False)), make_mesh(2, "cpu"))
    with pytest.raises(ValueError, match="mesh size must be >= 1"):
        make_mesh(0, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        TL.time_frames(cfg, 1, mesh=2)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        main(["--preset", "c1", "--frames", "1", "--mesh", "2"])
