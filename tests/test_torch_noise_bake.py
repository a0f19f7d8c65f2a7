"""volq_torch.volume: the uint32 hashes, Perlin noise, fBm and the bank
bake, held to volq.volume.

The hashes and the noise evaluated op by op are exact.  The bake is
compared with the reference's jitted bake, in which XLA contracts
a * b + c into fused multiply-adds and turns division by a constant
into a reciprocal multiply; the port rounds every operation as written
(the reference's own op-by-op semantics), so a few voxels may differ by
one bf16 ulp (ROADMAP Queue 3).
"""
import hashlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volq.volume import bake as jb, noise as jn
from volq_torch import _build
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


# sha256 (first 16 hex digits) of the CPU banks' bf16 bits before the
# noise kernel came in: the plain path's output may not move
_PLAIN_BANKS = {
    "4d": (lambda: tb.bake_bank_4d(4, 12, 2 ** 31 + 5, 0.75, octaves=3,
                                   noise_scale=4.5, ids=[3, 0, 6, 1],
                                   device="cpu"), "0a48bd0a6eb94c5f"),
    "3d": (lambda: tb.bake_bank(3, 12, 9, octaves=4, noise_scale=4.0,
                                cutoff=0.25, device="cpu"),
           "270de7ab2b59bda3"),
}


@pytest.mark.parametrize("bank", sorted(_PLAIN_BANKS))
def test_cpu_bakes_take_the_plain_path_unchanged(bank, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the noise kernel called on the CPU")

    monkeypatch.setattr(tb, "noise_bake", refuse)
    bake, digest = _PLAIN_BANKS[bank]
    got = bake()
    assert got.dtype == torch.bfloat16
    assert hashlib.sha256(got.view(torch.int16).numpy().tobytes()) \
        .hexdigest()[:16] == digest


@pytest.mark.parametrize("animated", [True, False], ids=["4d", "3d"])
def test_plain_bake_counts_noise_torch(animated):
    from torch.profiler import ProfilerActivity, profile
    from volq_torch.core import trace
    from volq_torch.scene.config import SceneConfig, VolumeConfig
    from volq_torch.scene.state import bake_volumes
    cfg = SceneConfig(volume=VolumeConfig(size=8, bank_size=2, octaves=1,
                                          animated=animated))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        bake_volumes(cfg, "cpu", 0.5)
    assert trace.counters() == {("volq.bake.volumes", "noise_torch"): 1}
    trace.reset()


def test_noise_kernel_is_built_with_the_others():
    assert "noise_bake" in _build.SOURCES
    src = (_build.CSRC / "noise_bake.cu").read_text()
    body = re.search(r"struct NoiseParams \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        names += [re.sub(r"\[.*", "", w).split()[-1]
                  for w in decl.strip().split(",") if w.strip()]
    assert names == [f[0] for f in tb.NoiseParams._fields_]
    assert tb._MAX_OCTAVES == int(re.search(
        r"kMaxOctaves = (\d+);", src).group(1))


_P = tb.noise_params(4, 8, 3, 3, 4.0, 0.3, 0.9, 0.5)


@pytest.mark.parametrize("case, error, match", [
    (dict(ids=torch.arange(4)), ValueError, "CUDA device"),
    (dict(ids=torch.arange(4, dtype=torch.int32)), TypeError, "dtype"),
    (dict(ids=torch.arange(8)[::2]), ValueError, "contiguous"),
    (dict(ids=torch.arange(3)), ValueError, "shape"),
    (dict(t=torch.tensor(0.5, dtype=torch.float64)), TypeError, "dtype"),
    (dict(t=torch.tensor(0.5)), ValueError, "CUDA device"),
    (dict(), ValueError, "CUDA device"),
], ids=["ids-cpu", "ids-int32", "ids-strided", "ids-short", "t-fp64",
        "t-cpu", "no-card"])
def test_noise_bake_refuses_before_loading(case, error, match, monkeypatch):
    def refuse(*args):
        raise AssertionError("loaded a kernel for refused inputs")

    monkeypatch.setattr(_build, "launch", refuse)
    with pytest.raises(error, match=match):
        tb.noise_bake(_P, "cpu", **case)


@pytest.mark.parametrize("bake", [
    lambda: tb.bake_bank(2, 8, 5, octaves=1, dtype=torch.float32),
    lambda: tb.bake_bank_4d(2, 8, 5, 0.5, octaves=1, dtype=torch.float32),
    lambda: tb.bake_bank_4d(2, 8, 5, 0.5, octaves=1, dtype=torch.float16,
                            ids=[1]),
], ids=["3d-fp32", "4d-fp32", "4d-fp16-ids"])
def test_card_bank_of_another_dtype_is_refused(bake, monkeypatch):
    """On the card a bank is the kernel's bf16: another dtype raises
    before anything is made on the card or loaded, and never falls back to
    the plain version."""
    def refuse(*args, **kwargs):
        raise AssertionError("reached a bake for a refused dtype")

    monkeypatch.setattr(tb, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(_build, "launch", refuse)
    for name in ("noise_bake", "_bake_plain"):
        monkeypatch.setattr(tb, name, refuse)
    with pytest.raises(ValueError, match="bf16"):
        bake()


def test_noise_params_round_as_torch_does():
    p = tb.noise_params(2, 33, -4, 3, 4.1, 0.35, 0.9, 0.37)
    f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))  # noqa: E731
    assert (p.denom, p.noise_scale, p.time_scale, p.cutoff, p.span) == (
        32.0, f32(4.1), f32(0.37), f32(0.35), f32(1.0 - 0.35))
    assert (list(p.amp[:3]), list(p.freq[:3]), p.norm) == (
        [1.0, 0.5, 0.25], [1.0, 2.0, 4.0], 1.75)
    assert list(p.seed[:3]) == [tn._seed_word(-4 + o) for o in range(3)]
    assert (p.off_seed, p.time_seed) == (tn._seed_word(97),
                                         tn._seed_word(198))
    with pytest.raises(ValueError):
        tb.noise_params(2, 8, 0, tb._MAX_OCTAVES + 1, 4.0, 0.3, 0.9)
