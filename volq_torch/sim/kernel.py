"""The sim step on the card: ``csrc/sim_step.cu``'s launches, bit-equal
to the plain version ``sim/step._sim_step_plain``, which the CPU takes.

A step is three launches on torch's current stream: ``sim_scan`` (one
block: ageing, death and each slot's emission rank), ``sim_spawn`` (the
spawning slots' threefry draws and every slot's attributes but the alive
ones' position and velocity; frame, carry and time) and ``sim_forces``
(gravity, drag, curl noise and the advection of the alive slots).  The
first two lie in the ``volq.sim.emit`` span, the third in
``volq.sim.forces``.  The step reads frame, time, the carry and the base
key where they lie on the card, and takes every constant as a kernel
argument (``SimParams``), so it makes no copy between host and card.
Each launch counts under its C function's name (``_build.launch``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from volq_torch import _build
from volq_torch._build import check_tensor, ptr, stream
from volq_torch.core import trace
from volq_torch.core.types import Particles, SceneState
from volq_torch.scene.config import EmitterConfig, ForcesConfig
from volq_torch.sim import prng
from volq_torch.sim.emit import _NORM_EPS, _THIRD
from volq_torch.sim.forces import _FD_H, _POT_OFF, _T_SCALE
from volq_torch.volume.noise import _seed_word

_F3 = ctypes.c_float * 3
_ERFINV = ctypes.c_float * len(prng._ERFINV_LT5)


class SimParams(ctypes.Structure):
    """``csrc/sim_step.cu``'s SimParams: the plain version's Python
    floats as the fp32 values torch rounds them to, its uint32 words as
    Python ints."""
    _fields_ = [("dt", ctypes.c_float), ("rate", ctypes.c_float),
                ("center", _F3), ("radius", ctypes.c_float),
                ("vel_base", _F3), ("vel_spread", ctypes.c_float),
                ("life_lo", ctypes.c_float), ("life_span", ctypes.c_float),
                ("size_lo", ctypes.c_float), ("size_span", ctypes.c_float),
                ("albedo_base", _F3), ("albedo_var", ctypes.c_float),
                ("third", ctypes.c_float), ("normal_lo", ctypes.c_float),
                ("normal_span", ctypes.c_float), ("sqrt2", ctypes.c_float),
                ("erfinv_lt", _ERFINV), ("erfinv_ge", _ERFINV),
                ("eps", ctypes.c_float), ("vol_span", ctypes.c_uint32),
                ("vol_mult", ctypes.c_uint32), ("gravity", _F3),
                ("drag", ctypes.c_float), ("curl_strength", ctypes.c_float),
                ("curl", ctypes.c_int), ("curl_freq", ctypes.c_float),
                ("fd_h", ctypes.c_float), ("fd_den", ctypes.c_float),
                ("t_scale", ctypes.c_float), ("pot_off", _F3 * 3),
                ("curl_seed", ctypes.c_uint32 * 3)]


# the state in and out of a launch (``csrc/sim_step.cu``'s SimTensors)
_STATE = ("pos", "vel", "age", "life", "size", "albedo", "vol", "frame",
          "carry", "time", "key")


class SimTensors(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in
                _STATE + tuple(f"{s}_o" for s in _STATE[:-1])]


@functools.lru_cache(maxsize=64)
def sim_params(dt: float, ecfg: EmitterConfig, fcfg: ForcesConfig,
               bank_size: int) -> SimParams:
    """The kernels' parameters for a scene's ``dt``, emitter, forces and
    volume bank size (``randint``'s span)."""
    life_lo, life_span = prng.uniform_bounds(ecfg.life_min, ecfg.life_max)
    size_lo, size_span = prng.uniform_bounds(ecfg.size_min, ecfg.size_max)
    normal_lo, normal_span = prng.uniform_bounds(prng.NORMAL_LO, 1.0)
    vol_span, vol_mult = prng.randint_span(0, bank_size)
    return SimParams(
        dt=dt, rate=ecfg.rate, center=_F3(*ecfg.center), radius=ecfg.radius,
        vel_base=_F3(*ecfg.vel_base), vel_spread=ecfg.vel_spread,
        life_lo=life_lo, life_span=life_span, size_lo=size_lo,
        size_span=size_span, albedo_base=_F3(*ecfg.albedo_base),
        albedo_var=ecfg.albedo_var, third=_THIRD, normal_lo=normal_lo,
        normal_span=normal_span, sqrt2=prng.SQRT2,
        erfinv_lt=_ERFINV(*prng._ERFINV_LT5),
        erfinv_ge=_ERFINV(*prng._ERFINV_GE5), eps=_NORM_EPS,
        vol_span=vol_span, vol_mult=vol_mult, gravity=_F3(*fcfg.gravity),
        drag=fcfg.drag, curl_strength=fcfg.curl_strength,
        curl=int(fcfg.curl_strength != 0.0), curl_freq=fcfg.curl_freq,
        fd_h=_FD_H, fd_den=2.0 * _FD_H, t_scale=_T_SCALE,
        pot_off=(_F3 * 3)(*(_F3(*o) for o in _POT_OFF)),
        curl_seed=(ctypes.c_uint32 * 3)(
            *(_seed_word(fcfg.curl_seed + c) for c in range(3))))


_V = ctypes.c_void_p
_ARGS = {
    "sim_scan_launch": [_V, _V, ctypes.c_int, ctypes.c_float, _V, _V, _V],
    "sim_spawn_launch": [SimTensors, _V, _V, ctypes.c_int, ctypes.c_int,
                         SimParams, _V],
    "sim_forces_launch": [SimTensors, ctypes.c_int, SimParams, _V],
}


def _empty(n: int, device) -> Particles:
    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)
    return Particles(pos=f32(n, 3), vel=f32(n, 3), age=f32(n),
                     lifetime=f32(n), size=f32(n), albedo=f32(n, 3),
                     vol_idx=torch.empty((n,), dtype=torch.int32,
                                         device=device))


def _inputs(state: SceneState) -> tuple:
    """The state's tensors in SimTensors' order, contiguous; raises on a
    dtype, shape or device other than the plain version makes."""
    p = state.particles
    n, dev = p.age.shape[0], p.age.device
    f32, i32 = (torch.float32,), (torch.int32,)
    ins = []
    for name, t, dtypes, shape in (
            ("pos", p.pos, f32, (n, 3)), ("vel", p.vel, f32, (n, 3)),
            ("age", p.age, f32, (n,)), ("lifetime", p.lifetime, f32, (n,)),
            ("size", p.size, f32, (n,)), ("albedo", p.albedo, f32, (n, 3)),
            ("vol_idx", p.vol_idx, i32, (n,)), ("frame", state.frame, i32, ()),
            ("spawn_carry", state.spawn_carry, f32, ()),
            ("time", state.time, f32, ()),
            ("base_key", state.base_key, (torch.int64,), (2,))):
        t = t.contiguous()
        check_tensor(t, name, dtypes, shape, dev)
        ins.append(t)
    return tuple(ins)


def sim_step_kernel(state: SceneState, cfg, offsets=None) -> SceneState:
    """``sim_step`` of a state on a card in three launches, bit-equal to
    ``_sim_step_plain``.  ``offsets(n, dead)`` -> (slot_offset,
    rank_offset) for a sharded step (``sim/step._rank_offsets``):
    ``dead`` this rank's dead slots, a 0-d int64 card tensor the first
    launch writes; ``rank_offset`` a 0-d int64 card tensor, or 0.
    Raises, before anything is built or loaded, on a state off a card or
    of another dtype, shape or layout than the plain version makes."""
    p = state.particles
    n, dev = p.age.shape[0], p.age.device
    if dev.type != "cuda":
        raise ValueError(f"sim_step runs on a CUDA device, not {dev} (the "
                         "CPU takes the plain version)")
    ins = _inputs(state)
    par = sim_params(cfg.dt, cfg.emitter, cfg.forces, cfg.volume.bank_size)
    out = _empty(n, dev)
    frame = torch.empty((), dtype=torch.int32, device=dev)
    carry = torch.empty((), dtype=torch.float32, device=dev)
    time = torch.empty((), dtype=torch.float32, device=dev)
    t = SimTensors(*(ptr(x) for x in (*ins, *out, frame, carry, time)))
    st = stream(dev)
    with trace.span("volq.sim.emit"):
        incl = torch.empty((n,), dtype=torch.int32, device=dev)
        dead = None if offsets is None else \
            torch.empty((), dtype=torch.int64, device=dev)
        _build.launch("sim_step", "sim_scan_launch", _ARGS["sim_scan_launch"],
                      ptr(ins[2]), ptr(ins[3]), n, par.dt, ptr(incl),
                      ptr(dead), st)
        slot_offset, rank_offset = (0, 0) if offsets is None \
            else offsets(n, dead)
        if torch.is_tensor(rank_offset):
            check_tensor(rank_offset, "rank_offset", (torch.int64,), (), dev)
        elif rank_offset:
            raise ValueError("rank_offset: a 0-d int64 tensor on the card, "
                             f"or 0, not {rank_offset!r}")
        else:
            rank_offset = None
        _build.launch("sim_step", "sim_spawn_launch",
                      _ARGS["sim_spawn_launch"], t, ptr(incl),
                      ptr(rank_offset), slot_offset, n, par, st)
    with trace.span("volq.sim.forces"):
        _build.launch("sim_step", "sim_forces_launch",
                      _ARGS["sim_forces_launch"], t, n, par, st)
    return SceneState(particles=out, volumes=state.volumes, frame=frame,
                      spawn_carry=carry, time=time, base_key=state.base_key)

