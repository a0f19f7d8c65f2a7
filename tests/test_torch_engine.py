"""volq_torch.engine's checkpoint, replay and frame output, on the CPU:
within the port (resume frame-exact, replay bit-equal, the PNG writer's
bytes) and across the packages (a checkpoint written by either loads in
the other, every array equal, and the next frame of each agrees within
the tolerances tests/test_torch_loop.py states for the same loop)."""
import dataclasses
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

import volq.scene.config as JC
from volq.engine import checkpoint as JCK
from volq.engine import loop as JL
import volq_torch.scene.config as TC
from volq_torch.convert import state_to_numpy
from volq_torch.engine import checkpoint as TCK
from volq_torch.engine import io as TIO
from volq_torch.engine import loop as TL
from volq_torch.engine.replay import replay_frame

POS_TOL = 1e-5      # the sim step against XLA's jit (tests/test_torch_loop.py)
IMG_TOL = 1e-5      # the exact engine against XLA's jit
BF16_TOL = 4 / 256  # the warp engine in bf16 (tests/test_torch_loop.py)


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


def _emitting(cfg):
    return dataclasses.replace(cfg, emitter=dataclasses.replace(
        cfg.emitter, rate=25.0, life_min=0.3, life_max=0.6))


def _tiny_warp():
    c = JC.c3()
    return dataclasses.replace(
        c, n_particles=16,
        volume=JC.VolumeConfig(size=16, bank_size=3, octaves=2,
                               noise_scale=5.0),
        render=dataclasses.replace(
            c.render, width=128, height=64, tile_w=32, warp_rect=48,
            warp_march_rect=32, warp_slab_vx=8, near_fade_start=0.0,
            near_fade_end=0.0))


def _states_equal(a, b):
    for x, y in zip(a.particles, b.particles):
        assert torch.equal(x, y)
    for f in ("volumes", "frame", "spawn_carry", "time", "base_key"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("engine", ["exact", "warp"])
def test_checkpoint_resume_is_frame_exact(tiny_cfg, tmp_path, engine):
    cfg = _port(_emitting(tiny_cfg) if engine == "exact" else _tiny_warp())
    state, camera, light = TL.setup(cfg, device="cpu")
    for _ in range(3):
        state, _, _ = TL.frame(state, camera, light, cfg)
    path = str(tmp_path / "ckpt.npz")
    TCK.save_state(path, state, cfg)
    restored, cfg2 = TCK.load_state(path, device="cpu")
    assert cfg2 == cfg
    _states_equal(state, restored)
    assert restored.volumes.dtype == torch.bfloat16
    assert restored.time.dtype == torch.float32
    assert restored.base_key.dtype == torch.int64
    for _ in range(3):
        state, img_a, _ = TL.frame(state, camera, light, cfg)
        restored, img_b, _ = TL.frame(restored, camera, light, cfg2)
    assert torch.equal(img_a, img_b)
    _states_equal(state, restored)


def test_load_state_without_device_needs_cuda(tiny_cfg, tmp_path,
                                              monkeypatch):
    cfg = _port(tiny_cfg)
    state, _, _ = TL.setup(cfg, device="cpu")
    path = str(tmp_path / "ckpt.npz")
    TCK.save_state(path, state, cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TCK.load_state(path)


def test_replay_frame_is_bit_exact(tiny_cfg):
    cfg = _port(_emitting(tiny_cfg))
    state, camera, light = TL.setup(cfg, device="cpu")
    imgs = []
    for _ in range(4):
        state, img, _ = TL.frame(state, camera, light, cfg)
        imgs.append(img)
    st_r, img_r, _ = replay_frame(cfg, 3, device="cpu")
    assert torch.equal(img_r, imgs[3])
    _states_equal(st_r, state)
    _, img_r0, _ = replay_frame(cfg, 0, device="cpu")
    assert torch.equal(img_r0, imgs[0])


def test_render_only_does_not_step(tiny_lit_cfg):
    cfg = _port(tiny_lit_cfg)
    state, camera, light = TL.setup(cfg, device="cpu")
    img, stats = TL.render_only(state, camera, light, cfg)
    assert int(state.frame) == 0 and int(stats["pairs_kept"]) > 0
    # the scene is static (no emission, no forces): a frame is a step that
    # only ages the particles, so the fade moves the image a little
    _, img_f, _ = TL.frame(state, camera, light, cfg)
    assert img.shape == img_f.shape
    assert float((img - img_f).abs().max()) < 1e-2


def test_png_writer(tmp_path):
    rgba = np.zeros((8, 16, 4), np.float32)
    rgba[..., 0] = 0.5
    rgba[..., 3] = 1.0
    u8 = TIO.tonemap(rgba)
    assert u8.dtype == np.uint8 and u8[0, 0].tolist() == [186, 0, 0, 255]
    path = str(tmp_path / "x.png")
    TIO.save_png(path, u8)
    raw = open(path, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", raw[16:24])
    assert (w, h) == (16, 8)
    at = raw.index(b"IDAT")
    idat_len = struct.unpack(">I", raw[at - 4:at])[0]
    decoded = zlib.decompress(raw[at + 4:at + 4 + idat_len])
    assert len(decoded) == h * (1 + w * 4)
    rows = np.frombuffer(decoded, np.uint8).reshape(h, 1 + w * 4)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(h, w, 4), u8)
    from PIL import Image
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), u8)


def test_tonemap_npy_downscale_gif(tmp_path):
    from volq.engine import io as JIO
    rng = np.random.default_rng(3)
    rgba = rng.random((16, 40, 4), dtype=np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(TIO.tonemap(rgba), JIO.tonemap(rgba))
    TIO.save_npy(str(tmp_path / "a.npy"), rgba)
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), rgba)
    u8 = TIO.tonemap(rgba)
    small = TIO.downscale_u8(u8, 20)
    assert small.shape == (8, 20, 4)
    np.testing.assert_array_equal(small, JIO.downscale_u8(u8, 20))
    assert TIO.downscale_u8(u8, 64) is u8
    frames = [u8, u8[::-1].copy(), u8[:, ::-1].copy()]
    TIO.save_gif(str(tmp_path / "a.gif"), frames, fps=10.0)
    from PIL import Image
    with Image.open(tmp_path / "a.gif") as im:
        assert im.n_frames == 3 and im.size == (40, 16)


def _npz_equal(a, b):
    za, zb = np.load(a), np.load(b)
    assert set(za.files) == set(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("engine", ["exact", "warp"])
def test_checkpoints_cross_packages(tiny_cfg, tmp_path, engine):
    """JAX -> port and port -> JAX: same npz schema, every array equal
    after the round trip, and the next frame of each package from the
    other's checkpoint agrees."""
    cfg = _emitting(tiny_cfg) if engine == "exact" else _tiny_warp()
    img_tol = IMG_TOL if engine == "exact" else BF16_TOL
    s, cam, li = JL.setup(cfg)
    for _ in range(2):
        s, _, _ = JL.frame(s, cam, li, cfg)
    jpath = str(tmp_path / "jax.npz")
    JCK.save_state(jpath, s, cfg)

    # JAX's checkpoint in the port
    ts, tcfg = TCK.load_state(jpath, device="cpu")
    assert tcfg == _port(cfg) and JC.to_json(cfg) == TC.to_json(tcfg)
    ref = jax.device_get(s)
    got = state_to_numpy(ts)
    for f in ref.particles._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref.particles, f)),
                                      getattr(got.particles, f), err_msg=f)
    for f in ("frame", "spawn_carry", "time", "base_key"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f), err_msg=f)
    np.testing.assert_array_equal(
        np.asarray(ref.volumes, np.float32), ts.volumes.float().numpy())
    # the port writes the same file back
    tpath = str(tmp_path / "torch.npz")
    TCK.save_state(tpath, ts, tcfg)
    _npz_equal(jpath, tpath)

    # the port's checkpoint in JAX
    s2, cfg2 = JCK.load_state(tpath)
    assert cfg2 == cfg
    for a, b in zip(jax.tree.leaves(jax.device_get(s)),
                    jax.tree.leaves(jax.device_get(s2))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32)
                                      if a.dtype.name == "bfloat16" else a,
                                      np.asarray(b, np.float32)
                                      if b.dtype.name == "bfloat16" else b)

    # the next frame of each, from the other's file
    tcam, tli = (TL.setup(tcfg, device="cpu"))[1:]
    ts, timg, tstats = TL.frame(ts, tcam, tli, tcfg)
    s2, img, stats = JL.frame(s2, cam, li, cfg2)
    img = np.asarray(img)
    assert img[..., 3].max() > 0.05
    assert np.abs(timg.numpy() - img).max() <= img_tol
    for k, v in tstats.items():
        assert int(v) == int(stats[k]), k
    got = state_to_numpy(ts)
    for f in ("pos", "vel", "age"):
        assert np.abs(np.asarray(getattr(s2.particles, f))
                      - getattr(got.particles, f)).max() <= POS_TOL, f
    assert int(got.frame) == int(s2.frame) == 3
