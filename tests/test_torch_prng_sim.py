"""volq_torch.sim: the threefry PRNG against jax.random, emission,
init and the sim step against volq.sim.

Keys, bits, uniform and randint are bit-identical.  ``normal`` runs
XLA's erf_inv polynomial with torch's log1p, which differs from XLA's by
an ulp on ~1% of inputs: held within 1e-6 (ROADMAP Queue 3).  Positions
and velocities go through pow, fused multiply-adds in the jitted
reference and curl-noise differences: held within 1e-5; so are the
other float attributes inside the jitted step (XLA contracts
``base * (1 - var * u)`` into a fused multiply-add there).  Spawn masks,
volume indices, the frame counter and the spawn carry are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volq.scene.config as JC
from volq.scene import init_scene
from volq.sim.emit import spawn_attrs as jspawn
from volq.sim.step import sim_step as jstep
import volq_torch.scene.config as TC
from volq_torch.convert import state_from_numpy, state_to_numpy
from volq_torch.scene.state import init_scene as tinit
from volq_torch.sim import prng
from volq_torch.sim.emit import spawn_attrs as tspawn
from volq_torch.sim.step import sim_step as tstep

SEEDS = [0, 3, 11, 2 ** 31 - 1]
POS_TOL = 1e-5


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, "cpu")


def _u32(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_bits_exact(seed):
    k, kt = _key(seed)
    np.testing.assert_array_equal(_u32(k), kt.numpy())
    for d in (0, 5, 0x5EED, 123456789):
        np.testing.assert_array_equal(_u32(jax.random.fold_in(k, d)),
                                      prng.fold_in(kt, d).numpy())
    np.testing.assert_array_equal(_u32(jax.random.split(k, 7)),
                                  prng.split(kt, 7).numpy())
    np.testing.assert_array_equal(_u32(jax.random.bits(k, (5, 3))),
                                  prng.random_bits(kt, (5, 3)).numpy())
    # a batch of keys maps like vmap
    ks = jax.random.split(k, 4)
    np.testing.assert_array_equal(
        _u32(jax.vmap(lambda x: jax.random.split(x, 3))(ks)),
        prng.split(torch.from_numpy(_u32(ks)), 3).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_randint_exact_normal_close(seed):
    k, kt = _key(seed)
    for lo, hi in ((0.0, 1.0), (3.0, 6.0), (0.26, 0.42), (0.45, 0.55)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(k, (4000,), jnp.float32, lo, hi)),
            prng.uniform(kt, (4000,), lo, hi).numpy())
    for m in (1, 4, 80, 1000, 1024):
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(k, (300,), 0, m, jnp.int32)),
            prng.randint(kt, (300,), 0, m).numpy())
    ref = np.asarray(jax.random.normal(k, (4000,), jnp.float32))
    got = prng.normal(kt, (4000,)).numpy()
    assert np.abs(ref - got).max() <= 1e-6


def _tiny_c3(n=16, init="empty"):
    """c3's emitter and forces on a tiny scene (2 x 16^3 bank)."""
    c = JC.c3()
    return dataclasses.replace(
        c, n_particles=n, init=init,
        volume=JC.VolumeConfig(size=16, bank_size=2, octaves=2))


def _port(cfg):
    return TC.from_json(JC.to_json(cfg))


def _cmp_particles(ref, got, exact=("age", "lifetime", "size", "albedo",
                                     "vol_idx")):
    for f in ref._fields:
        a = np.asarray(getattr(ref, f))
        b = np.asarray(getattr(got, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f in exact:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert np.abs(a - b).max() <= POS_TOL, f


def test_spawn_attrs_match():
    cfg = JC.c3()
    k, kt = _key(5)
    ref = jax.device_get(jspawn(k, jnp.arange(64, dtype=jnp.int32),
                                cfg.emitter, 1024))
    got = tspawn(kt, torch.arange(64, dtype=torch.int32),
                 _port(cfg).emitter, 1024)
    for f in ("lifetime", "size", "albedo", "vol_idx"):
        np.testing.assert_array_equal(np.asarray(ref[f]), got[f].numpy())
    for f in ("pos", "vel"):
        assert np.abs(np.asarray(ref[f]) - got[f].numpy()).max() <= POS_TOL


@pytest.mark.parametrize("init", ["random", "grid"])
def test_init_scene_matches(init):
    cfg = _tiny_c3(init=init)
    ref = jax.device_get(init_scene(cfg))
    got = state_to_numpy(tinit(_port(cfg), "cpu"))
    _cmp_particles(ref.particles, got.particles)
    np.testing.assert_array_equal(np.asarray(ref.volumes, np.float32),
                                  np.asarray(got.volumes, np.float32))
    np.testing.assert_array_equal(np.asarray(ref.base_key), got.base_key)


@pytest.mark.parametrize("init", ["empty", "random"])
def test_sim_step_three_frames(init):
    """From the same state: three steps of emission (empty pool) or of
    curl-forced advection (random pool)."""
    cfg = _tiny_c3(init=init)
    s = init_scene(cfg)
    st = state_from_numpy(jax.device_get(s), "cpu")
    step = jax.jit(jstep, static_argnames=("cfg",))
    tcfg = _port(cfg)
    spawned = 0
    for _ in range(3):
        s = step(s, cfg)
        st = tstep(st, tcfg)
        mask = st.particles.age.numpy() == 0
        np.testing.assert_array_equal(np.asarray(s.particles.age) == 0, mask)
        spawned += int(mask.sum())
    ref = jax.device_get(s)
    got = state_to_numpy(st)
    _cmp_particles(ref.particles, got.particles, exact=("vol_idx",))
    for f in ("frame", "spawn_carry", "time"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f), err_msg=f)
    if init == "empty":
        assert spawned > 0
