"""The port's public functions that take ``device=`` run on the card unless
the caller asks for the CPU: called without a device where torch sees no
card they raise (nothing silently carries on on the CPU), and with
``device="cpu"`` they run there.  ``torch.cuda.is_available`` is patched
to False, so the cases hold on a machine with a card too."""
import numpy as np
import pytest
import torch

from volq_torch import convert
from volq_torch.scene import state as S
from volq_torch.scene.config import (SceneConfig, VolumeConfig,
                                     CameraConfig, LightConfig)
from volq_torch.sim import prng
from volq_torch.volume import bake

CFG = SceneConfig(n_particles=4, init="random", seed=3,
                  volume=VolumeConfig(size=8, bank_size=2, octaves=1))
ANIMATED = SceneConfig(n_particles=4, init="random", seed=3,
                       volume=VolumeConfig(size=8, bank_size=2, octaves=1,
                                           animated=True))


def _host_state():
    return convert.state_to_numpy(S.init_scene(CFG, "cpu"))


def _host(nt):
    return type(nt)(*(t.numpy() for t in nt))


ENTRY_POINTS = {
    "init_scene": lambda **d: S.init_scene(CFG, **d),
    "build_camera": lambda **d: S.build_camera(CameraConfig(), 64, 32, **d),
    "build_light": lambda **d: S.build_light(LightConfig(), **d),
    "bake_volumes": lambda **d: S.bake_volumes(CFG, **d),
    "bake_volumes_animated": lambda **d: S.bake_volumes(ANIMATED, **d),
    "PRNGKey": lambda **d: prng.PRNGKey(7, **d),
    "bake_bank": lambda **d: bake.bake_bank(2, 8, 5, octaves=1, **d),
    "bake_bank_4d": lambda **d: bake.bake_bank_4d(2, 8, 5, 0.5, octaves=1,
                                                  **d),
    "state_from_numpy": lambda **d: convert.state_from_numpy(_host_state(),
                                                             **d),
    "light_volumes_from_numpy": lambda **d: convert.light_volumes_from_numpy(
        np.ones((2, 8, 8, 8), np.float32), **d),
    "camera_from_numpy": lambda **d: convert.camera_from_numpy(
        _host(S.build_camera(CameraConfig(), 64, 32, "cpu")), **d),
    "light_from_numpy": lambda **d: convert.light_from_numpy(
        _host(S.build_light(LightConfig(), "cpu")), **d),
}


def _tensors(x):
    if torch.is_tensor(x):
        return [x]
    return [t for v in x for t in _tensors(v)]


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_needs_a_card_unless_asked_for_the_cpu(name,
                                                          monkeypatch):
    fn = ENTRY_POINTS[name]
    on_cpu = fn(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(device=None)
    got = _tensors(on_cpu)
    assert got and all(t.device.type == "cpu" for t in got)
