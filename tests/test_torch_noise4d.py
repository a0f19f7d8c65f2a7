"""volq_torch.volume: the 4-D noise and the animated bank bake against
the JAX package (same numpy-seeded inputs through both).

The hashes are exact; the fp32 gradient math is op for op the
reference's eager arithmetic, so ``perlin4`` / ``fbm4`` are equal to the
reference's eager values.  XLA's jit contracts a*b+c into fused
multiply-adds: against the jitted reference ``fbm4`` is held to 2e-6 and
the bf16 bank to one bf16 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volq.volume import bake as jb
from volq.volume import noise as jn
import volq.scene.config as JC
from volq.scene.state import bake_volumes as j_bake_volumes
import volq_torch.scene.config as TC
from volq_torch.scene.state import bake_volumes
from volq_torch.volume import bake as tb
from volq_torch.volume import noise as tn


def _points(n, span, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, 4), dtype=np.float32) - 0.5) * span) \
        .astype(np.float32)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_hash_base_with_w_exact(seed):
    rng = np.random.default_rng(1)
    ix, iy, iz, iw = (rng.integers(-2 ** 31, 2 ** 31, 4096).astype(np.int32)
                      for _ in range(4))
    ref = np.asarray(jn._hash_base(*(jnp.asarray(a) for a in (ix, iy, iz)),
                                   seed, jnp.asarray(iw)))
    got = tn._hash_base(*(torch.from_numpy(a) for a in (ix, iy, iz)), seed,
                        torch.from_numpy(iw)).numpy()
    np.testing.assert_array_equal(ref.astype(np.int64), got)
    # without w it is the 3-D hash, and w really enters
    ref3 = np.asarray(jn._hash_base(*(jnp.asarray(a) for a in (ix, iy, iz)),
                                    seed))
    got3 = tn._hash_base(*(torch.from_numpy(a) for a in (ix, iy, iz)),
                         seed).numpy()
    np.testing.assert_array_equal(ref3.astype(np.int64), got3)
    assert (got != got3).mean() > 0.99


@pytest.mark.parametrize("span", [8.0, 200.0], ids=["near", "far"])
def test_perlin4_equals_eager_reference(span):
    p = _points(6000, span, 2)
    ref = np.asarray(jn.perlin4(jnp.asarray(p), 11))
    got = tn.perlin4(torch.from_numpy(p), 11).numpy()
    np.testing.assert_array_equal(ref, got)
    assert np.abs(got).max() > 0.3 and np.abs(got).max() < 2.0
    # lattice points: the gradient dot vanishes
    lat = np.floor(p)
    assert np.abs(tn.perlin4(torch.from_numpy(lat), 11).numpy()).max() == 0.0


@pytest.mark.parametrize("octaves", [1, 3])
def test_fbm4_matches(octaves):
    p = _points(6000, 40.0, 3)
    eager = np.asarray(jn.fbm4(jnp.asarray(p), 5, octaves=octaves))
    jitted = np.asarray(jax.jit(
        lambda x: jn.fbm4(x, 5, octaves=octaves))(jnp.asarray(p)))
    got = tn.fbm4(torch.from_numpy(p), 5, octaves=octaves).numpy()
    np.testing.assert_array_equal(eager, got)
    assert np.abs(jitted - got).max() <= 2e-6


@pytest.mark.parametrize("t", [0.0, 1.2345], ids=["t0", "t1.2345"])
def test_bake_bank_4d_within_one_bf16_ulp(t):
    kw = dict(octaves=2, noise_scale=5.0, time_scale=0.5)
    ref = np.asarray(jb.bake_bank_4d(5, 16, 3, t, **kw).astype(jnp.float32))
    bank = tb.bake_bank_4d(5, 16, 3, torch.tensor(t), **kw)
    assert bank.dtype == torch.bfloat16 and tuple(bank.shape) == (5,) + (16,) * 3
    got = bank.float().numpy()
    assert ref.max() > 0.3
    # one bf16 ulp of the larger value, on a few voxels at most
    d = np.abs(ref - got)
    assert (d <= np.maximum(np.abs(ref), np.abs(got)) * 2.0 ** -7).all()
    assert (d > 0).mean() < 1e-3
    # the entries differ, and the bank moves with time
    assert np.abs(got[0] - got[1]).max() > 0.05
    other = tb.bake_bank_4d(5, 16, 3, t + 0.5, **kw).float().numpy()
    assert np.abs(other - got).max() > 0.02


def test_bake_bank_4d_is_chunk_independent(monkeypatch):
    kw = dict(octaves=1, noise_scale=4.0)
    whole = tb.bake_bank_4d(5, 8, 9, 0.7, **kw)
    monkeypatch.setattr(tb, "_CHUNK_VOXELS", 2 * 8 ** 3)
    assert torch.equal(whole, tb.bake_bank_4d(5, 8, 9, 0.7, **kw))


def test_bake_volumes_animated():
    """scene.state.bake_volumes dispatches on ``volume.animated`` and
    passes the config's time scale."""
    vol = JC.VolumeConfig(size=8, bank_size=3, octaves=1, animated=True,
                          time_scale=0.8)
    cfg = JC.SceneConfig(volume=vol)
    tcfg = TC.from_json(JC.to_json(cfg))
    ref = np.asarray(j_bake_volumes(cfg, t=0.6).astype(jnp.float32))
    got = bake_volumes(tcfg, "cpu", 0.6).float().numpy()
    assert np.abs(ref - got).max() <= 2.0 ** -8
    assert not np.array_equal(got, bake_volumes(tcfg, "cpu").float().numpy())
