"""numpy <-> port state.  ``state_from_numpy`` takes the JAX package's
SceneState as numpy arrays (what ``jax.device_get(state)`` returns, any
NamedTuple with the same fields) and builds the port's; the volume bank
keeps its bf16 storage.  This is how tests hand both packages the same
inputs."""
from __future__ import annotations

import numpy as np
import torch

from volq_torch.core.device import resolve_device
from volq_torch.core.types import Camera, Light, Particles, SceneState


def _to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)) \
            .view(torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(np.uint16) \
            .view(ml_dtypes.bfloat16)
    return t.numpy()


def state_from_numpy(d, device=None) -> SceneState:
    """``d.volumes`` may be the bf16 bank or its fp32 widening (what a
    checkpoint stores): fp32 is narrowed to bf16 on the host, before the
    upload to ``device`` (None: the card; raises without one)."""
    device = resolve_device(device)
    p = d.particles
    parts = Particles(*(_to_torch(getattr(p, f), device)
                        for f in Particles._fields))
    volumes = np.asarray(d.volumes)
    if volumes.dtype == np.float32:
        volumes = torch.from_numpy(volumes).to(torch.bfloat16).to(device)
    else:
        volumes = _to_torch(volumes, device)
    return SceneState(
        particles=parts,
        volumes=volumes,
        frame=_to_torch(np.asarray(d.frame, np.int32), device),
        spawn_carry=_to_torch(np.asarray(d.spawn_carry, np.float32), device),
        time=_to_torch(np.asarray(d.time, np.float32), device),
        base_key=_to_torch(np.asarray(d.base_key, np.uint32), device))


def state_to_numpy(state: SceneState, bank_fp32: bool = False) -> SceneState:
    """Port state -> the same NamedTuple of numpy arrays, with the key
    back as uint32 and the bank as ml_dtypes bfloat16, or (``bank_fp32``,
    what a checkpoint stores) widened to fp32."""
    p = state.particles
    volumes = state.volumes.detach().cpu().to(torch.float32).numpy() \
        if bank_fp32 else _to_numpy(state.volumes)
    return SceneState(
        particles=Particles(*(_to_numpy(getattr(p, f))
                              for f in Particles._fields)),
        volumes=volumes,
        frame=_to_numpy(state.frame),
        spawn_carry=_to_numpy(state.spawn_carry),
        time=_to_numpy(state.time),
        base_key=_to_numpy(state.base_key).astype(np.uint32))


def light_volumes_from_numpy(lv, device=None) -> torch.Tensor:
    """The baked light optical-depth bank [M, V, V, V] (what
    ``volq.volume.lightbake.bake_light_volumes`` returns, as numpy) ->
    the port's fp32 tensor on ``device`` (None: the card), so both
    packages can render from one bake."""
    return _to_torch(np.asarray(lv, np.float32), resolve_device(device))


def camera_from_numpy(c, device=None) -> Camera:
    """A numpy camera on ``device`` (None: the card)."""
    device = resolve_device(device)
    return Camera(*(_to_torch(np.asarray(getattr(c, f), np.float32), device)
                    for f in Camera._fields))


def light_from_numpy(lt, device=None) -> Light:
    """A numpy light on ``device`` (None: the card)."""
    device = resolve_device(device)
    return Light(*(_to_torch(np.asarray(getattr(lt, f), np.float32), device)
                   for f in Light._fields))


def camera_to_numpy(c: Camera) -> Camera:
    return Camera(*(_to_numpy(v) for v in c))


def light_to_numpy(lt: Light) -> Light:
    return Light(*(_to_numpy(v) for v in lt))
