"""volq_torch's sim kernels (``csrc/sim_step.cu``, ``sim/kernel.py``):
their parameters and the CPU's dispatch here, and on the card each held
bit-equal to the plain version on the card in every attribute and in
frame, time and the spawn carry.  Imports neither JAX nor volq, so the
card cases run where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_sim_kernel.py -q

The card cases: 16 frames of c5's 16384 slots (aged so that slots die
and respawn every frame); c3's and c4's particle counts with ``init``
``random`` and ``grid``, four steps each; an emitter whose carry crosses
an integer; the sharded step's inputs (``slot_offset``, ``rank_offset``)
at nonzero values; c2's scene without forces or emitter.  The plain
version they are held to reaches no kernel.  Without a card they skip
(the kernels have no CPU mode).
"""
import dataclasses
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from volq_torch import _build
from volq_torch.core import trace
from volq_torch.scene import state as S
from volq_torch.scene.config import VolumeConfig, c2, c3, c4, c5
from volq_torch.sim import forces, prng
from volq_torch.sim import kernel as SK
from volq_torch.sim import step


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return float(torch.tensor(x, dtype=torch.float32))


@pytest.mark.parametrize("preset", [c3, c4, c5], ids=["c3", "c4", "c5"])
def test_params_are_the_fp32_torch_rounds_to(preset):
    cfg = preset()
    e, f = cfg.emitter, cfg.forces
    p = SK.sim_params(cfg.dt, e, f, cfg.volume.bank_size)
    for name, want in (("dt", cfg.dt), ("rate", e.rate),
                       ("radius", e.radius), ("vel_spread", e.vel_spread),
                       ("albedo_var", e.albedo_var), ("third", 1.0 / 3.0),
                       ("eps", 1e-6), ("drag", f.drag),
                       ("curl_strength", f.curl_strength),
                       ("curl_freq", f.curl_freq), ("fd_h", 0.05),
                       ("fd_den", 0.1), ("t_scale", 0.1)):
        assert getattr(p, name) == _f32(want), name
    for name, want in (("center", e.center), ("vel_base", e.vel_base),
                       ("albedo_base", e.albedo_base),
                       ("gravity", f.gravity),
                       ("erfinv_lt", prng._ERFINV_LT5),
                       ("erfinv_ge", prng._ERFINV_GE5)):
        assert list(getattr(p, name)) == [_f32(x) for x in want], name
    assert [list(r) for r in p.pot_off] == [[_f32(x) for x in o]
                                            for o in forces._POT_OFF]
    # uniform's floor and span: fp32 values, the span their fp32 difference
    assert (p.life_lo, p.life_span) == (
        _f32(e.life_min), _f32(_f32(e.life_max) - _f32(e.life_min)))
    assert (p.size_lo, p.size_span) == (
        _f32(e.size_min), _f32(_f32(e.size_max) - _f32(e.size_min)))
    assert (p.normal_lo, p.normal_span, p.sqrt2) == (
        _f32(-1.0 + 2.0 ** -24), 2.0, _f32(2.0 ** 0.5))
    span = cfg.volume.bank_size
    assert (p.vol_span, p.vol_mult) == (span, (2 ** 32) % span)
    assert list(p.curl_seed) == [
        ((f.curl_seed + c) * 0x9E3779B9) % 2 ** 32 for c in range(3)]
    assert p.curl == 1


def test_no_curl_is_a_flag_and_params_are_cached():
    cfg = c3()
    f = dataclasses.replace(cfg.forces, curl_strength=0.0)
    assert SK.sim_params(cfg.dt, cfg.emitter, f, 4).curl == 0
    assert SK.sim_params(cfg.dt, cfg.emitter, f, 4) is \
        SK.sim_params(cfg.dt, cfg.emitter, f, 4)


def _fields(src: str, struct: str) -> list:
    body = re.search(rf"struct {struct} \{{(.*?)\}};", src, re.S).group(1)
    names = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        names += [re.sub(r"\[.*", "", w).split()[-1].lstrip("*")
                  for w in decl.strip().split(",") if w.strip()]
    return names


def test_sim_kernel_is_built_with_the_others():
    assert "sim_step" in _build.SOURCES
    src = (_build.CSRC / "sim_step.cu").read_text()
    assert _fields(src, "SimParams") == [f[0] for f in SK.SimParams._fields_]
    assert _fields(src, "SimTensors") == [f[0]
                                          for f in SK.SimTensors._fields_]
    # the noise kernel and the sim share one copy of the Perlin code
    assert '#include "noise_common.cuh"' in src
    bake = (_build.CSRC / "noise_bake.cu").read_text()
    assert '#include "noise_common.cuh"' in bake
    assert "perlin(" not in bake and "uint32_t mix(" not in bake


def test_the_wrapper_binds_every_launch_the_source_exports():
    src = (_build.CSRC / "sim_step.cu").read_text()
    exported = re.findall(r'extern "C" int (\w+)\(', src)
    assert sorted(exported) == sorted(SK._ARGS)
    assert len(re.findall(r"__global__", src)) == len(exported) == 3


def _tiny(n=24, init="random", **kw):
    c = c3()
    return dataclasses.replace(
        c, n_particles=n, init=init,
        volume=VolumeConfig(size=8, bank_size=5, octaves=1), **kw)


def _refuse(*args, **kwargs):
    raise AssertionError("a sim kernel reached on the CPU")


def test_cpu_step_takes_the_plain_path_and_counts_sim_torch(monkeypatch):
    cfg = _tiny(init="empty")
    state = S.init_scene(cfg, "cpu")
    plain = step._sim_step_plain(state, cfg)
    monkeypatch.setattr(_build, "launch", _refuse)
    monkeypatch.setattr(SK, "sim_step_kernel", _refuse)
    monkeypatch.setattr(step, "sim_step_kernel", _refuse)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = step.sim_step(state, cfg)
    assert trace.counters() == {("volq.sim", "sim_torch"): 1}
    trace.reset()
    assert int(got.particles.age.eq(0).sum()) > 0          # spawned
    for a, b in zip(plain.particles, got.particles):
        assert torch.equal(a, b)
    for f in ("frame", "spawn_carry", "time"):
        assert torch.equal(getattr(plain, f), getattr(got, f))


def test_kernels_refuse_the_cpu_before_loading(monkeypatch):
    monkeypatch.setattr(_build, "launch", _refuse)
    with pytest.raises(ValueError, match="CUDA device"):
        SK.sim_step_kernel(S.init_scene(_tiny(), "cpu"), _tiny())


# ---- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sim kernels have no CPU mode)")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _equal(a, b, what):
    """Every particle attribute, frame, carry and time bit for bit."""
    for f in a.particles._fields:
        x, y = getattr(a.particles, f), getattr(b.particles, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
        assert torch.equal(_bits(x), _bits(y)), (what, f)
    for f in ("frame", "spawn_carry", "time"):
        assert torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f))), \
            (what, f)


def _steps(state, cfg, n, offsets=None):
    """``n`` steps by the kernels and by the plain version from one
    state, held equal after each; returns the slots spawned a step.  The
    plain version loads no kernel."""
    k = p = state
    spawned = []
    for i in range(n):
        n0 = _build.launches.copy()
        k = SK.sim_step_kernel(k, cfg, offsets)
        assert _build.launches - n0 == dict.fromkeys(SK._ARGS, 1)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(_build, "launch", _refuse)
            p = step._sim_step_plain(p, cfg, offsets)
        _equal(k, p, f"step {i}")
        spawned.append(int(k.particles.age.eq(0).sum()))
    return spawned


def _small_bank(cfg):
    """The sim reads only the bank's size: a bank of 8^3 entries."""
    return dataclasses.replace(cfg, volume=dataclasses.replace(
        cfg.volume, size=8, octaves=1))


@pytest.mark.gpu
def test_c5_sixteen_frames_bit_equal():
    _card()
    cfg = dataclasses.replace(_small_bank(c5()), init_age_frac=(0.95, 1.01))
    state = S.init_scene(cfg)
    assert state.particles.age.shape == (16384,)
    spawned = _steps(state, cfg, 16)
    assert min(spawned) > 0, spawned


@pytest.mark.gpu
@pytest.mark.parametrize("init", ["random", "grid"])
@pytest.mark.parametrize("preset", [c3, c4], ids=["c3", "c4"])
def test_init_and_steps_bit_equal(preset, init):
    _card()
    cfg = dataclasses.replace(_small_bank(preset()), init=init,
                              init_age_frac=(0.9, 1.05))
    assert sum(_steps(S.init_scene(cfg), cfg, 4)) > 0


@pytest.mark.gpu
def test_no_curl_and_no_emission_bit_equal():
    """c2's scene: no forces and no emitter (the kernels' curl-free
    branch), ages far from death."""
    _card()
    cfg = _small_bank(c2())
    assert cfg.forces.curl_strength == 0.0 and cfg.emitter.rate == 0.0
    assert _steps(S.init_scene(cfg), cfg, 3) == [0, 0, 0]


@pytest.mark.gpu
def test_carry_crossing_an_integer():
    _card()
    cfg = _small_bank(_tiny(n=64, init="empty",
                            emitter=dataclasses.replace(c3().emitter,
                                                        rate=37.0)))
    spawned = _steps(S.init_scene(cfg), cfg, 12)
    assert set(spawned) == {0, 1}, spawned          # 0.6167 a frame


@pytest.mark.gpu
@pytest.mark.parametrize("slot_offset, rank_offset", [(3 * 512 + 5, 2),
                                                      (512, 0)])
def test_sharded_inputs_at_nonzero_values(slot_offset, rank_offset):
    _card()
    cfg = dataclasses.replace(_small_bank(c3()), n_particles=512,
                              init_age_frac=(0.9, 1.05))
    seen = []

    def offsets(n, dead):
        seen.append(int(dead))
        return slot_offset, torch.tensor(rank_offset, device="cuda")

    state = S.init_scene(cfg)
    assert min(_steps(state, cfg, 3, offsets)) > 0     # 4.27 a frame
    # the kernel's dead count and the plain version's, step by step
    assert seen[0::2] == seen[1::2] and min(seen) > rank_offset

