"""volq_torch.volume: the uint32 hashes, Perlin noise, fBm and the bank
bake, held to volq.volume.

The hashes and the noise evaluated op by op are exact.  The bake is
compared with the reference's jitted bake, in which XLA contracts
a * b + c into fused multiply-adds and turns division by a constant
into a reciprocal multiply; the port rounds every operation as written
(the reference's own op-by-op semantics), so a few voxels may differ by
one bf16 ulp (ROADMAP Queue 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volq.volume import bake as jb, noise as jn
from volq_torch.volume import bake as tb, noise as tn


def _ints(rng, n):
    return rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)


def test_hashes_exact():
    rng = np.random.default_rng(0)
    ix, iy, iz = _ints(rng, 4096), _ints(rng, 4096), _ints(rng, 4096)
    for seed in (0, 7, 0x7FFFFFFF):
        ref = np.asarray(jn._hash_base(jnp.asarray(ix), jnp.asarray(iy),
                                       jnp.asarray(iz), seed))
        got = tn._hash_base(torch.from_numpy(ix), torch.from_numpy(iy),
                            torch.from_numpy(iz), seed).numpy()
        np.testing.assert_array_equal(ref.astype(np.int64), got)
    h = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(jn._mix(jnp.asarray(h))).astype(np.int64),
        tn._mix(torch.from_numpy(h.astype(np.int64))).numpy())
    np.testing.assert_array_equal(
        np.asarray(jn._u2f(jnp.asarray(h))),
        tn._u2f(torch.from_numpy(h.astype(np.int64))).numpy())


@pytest.mark.parametrize("seed", [0, 9, 123])
def test_perlin_and_fbm_exact(seed):
    rng = np.random.default_rng(seed)
    p = (rng.standard_normal((3000, 3)) * 40).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jn.perlin3(jnp.asarray(p), seed)),
        tn.perlin3(torch.from_numpy(p), seed).numpy())
    np.testing.assert_array_equal(
        np.asarray(jn.fbm3(jnp.asarray(p), seed, octaves=5)),
        tn.fbm3(torch.from_numpy(p), seed, octaves=5).numpy())


def test_volume_offsets_and_lattice_exact():
    ids = np.arange(0, 2000, 7, dtype=np.int32)
    np.testing.assert_array_equal(
        np.asarray(jb._volume_offsets(jnp.asarray(ids), 9)),
        tb._volume_offsets(torch.from_numpy(ids), 9).numpy())
    np.testing.assert_array_equal(np.asarray(jb._lattice(24)),
                                  tb._lattice(24, "cpu").numpy())


def _bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("args", [
    dict(bank_size=3, size=16, seed=7, octaves=2),
    dict(bank_size=5, size=24, seed=9, octaves=5, noise_scale=5.0),
], ids=["3x16", "5x24"])
def test_bake_bank_within_one_bf16_ulp(args):
    ref = np.asarray(jb.bake_bank(**args).astype(jnp.float32), np.float64)
    got = tb.bake_bank(**args, device="cpu")
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().astype(np.float64)
    assert ref.max() > 0.05
    diff = np.abs(ref - got)
    assert (diff <= _bf16_ulp(ref)).all(), diff.max()
    assert (diff > 0).mean() < 1e-3


def test_bake_chunking_is_invisible(monkeypatch):
    whole = tb.bake_bank(6, 16, 3, octaves=3, device="cpu")
    monkeypatch.setattr(tb, "_CHUNK_VOXELS", 16 ** 3 * 4)   # 4 per chunk
    assert torch.equal(tb.bake_bank(6, 16, 3, octaves=3, device="cpu"), whole)


def test_bake_bank_4d_ids_select_entries(monkeypatch):
    """``ids`` bakes the named global entries (the sharded frame splits
    the animated bake over ranks this way): equal to those entries of
    the whole bank, in any order and across bake chunks; the JAX
    package's ``ids`` selects the same entries."""
    kw = dict(octaves=2, noise_scale=4.5, time_scale=0.5)
    whole = tb.bake_bank_4d(6, 12, 5, 0.75, device="cpu", **kw)
    monkeypatch.setattr(tb, "_CHUNK_VOXELS", 12 ** 3 * 2)   # 2 per chunk
    ids = [4, 1, 5]
    got = tb.bake_bank_4d(6, 12, 5, 0.75, device="cpu",
                          ids=torch.tensor(ids), **kw)
    assert torch.equal(got, whole[ids])
    ref = np.asarray(jb.bake_bank_4d(6, 12, 5, 0.75, ids=jnp.asarray(ids),
                                     **kw).astype(jnp.float32), np.float64)
    full = np.asarray(jb.bake_bank_4d(6, 12, 5, 0.75, **kw)
                      .astype(jnp.float32), np.float64)
    assert np.array_equal(ref, full[ids])
    diff = np.abs(ref - got.float().numpy())
    assert ref.max() > 0.05 and (diff <= _bf16_ulp(ref)).all()
