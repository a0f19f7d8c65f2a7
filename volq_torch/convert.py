"""numpy <-> port state.  ``state_from_numpy`` takes the JAX package's
SceneState as numpy arrays (what ``jax.device_get(state)`` returns, any
NamedTuple with the same fields) and builds the port's; the volume bank
keeps its bf16 storage.  This is how tests hand both packages the same
inputs."""
from __future__ import annotations

import numpy as np
import torch

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


def state_from_numpy(d, device="cpu") -> SceneState:
    p = d.particles
    parts = Particles(*(_to_torch(getattr(p, f), device)
                        for f in Particles._fields))
    return SceneState(
        particles=parts,
        volumes=_to_torch(d.volumes, device),
        frame=_to_torch(np.asarray(d.frame, np.int32), device),
        spawn_carry=_to_torch(np.asarray(d.spawn_carry, np.float32), device),
        time=_to_torch(np.asarray(d.time, np.float32), device),
        base_key=_to_torch(np.asarray(d.base_key, np.uint32), device))


def state_to_numpy(state: SceneState) -> SceneState:
    """Port state -> the same NamedTuple of numpy arrays, with the key
    back as uint32 and the bank as ml_dtypes bfloat16."""
    p = state.particles
    return SceneState(
        particles=Particles(*(_to_numpy(getattr(p, f))
                              for f in Particles._fields)),
        volumes=_to_numpy(state.volumes),
        frame=_to_numpy(state.frame),
        spawn_carry=_to_numpy(state.spawn_carry),
        time=_to_numpy(state.time),
        base_key=_to_numpy(state.base_key).astype(np.uint32))


def camera_from_numpy(c, device="cpu") -> Camera:
    return Camera(*(_to_torch(np.asarray(getattr(c, f), np.float32), device)
                    for f in Camera._fields))


def light_from_numpy(lt, device="cpu") -> Light:
    return Light(*(_to_torch(np.asarray(getattr(lt, f), np.float32), device)
                   for f in Light._fields))


def camera_to_numpy(c: Camera) -> Camera:
    return Camera(*(_to_numpy(v) for v in c))


def light_to_numpy(lt: Light) -> Light:
    return Light(*(_to_numpy(v) for v in lt))
