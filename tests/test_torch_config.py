"""volq_torch: config copy, state converters and the package's import
boundary (no JAX, nothing of volq), held to the JAX package exactly."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import volq.scene.config as JC
from volq.scene import init_scene
import volq_torch.scene.config as TC
from volq_torch.convert import (state_from_numpy, state_to_numpy,
                                camera_from_numpy, camera_to_numpy,
                                light_from_numpy, light_to_numpy)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", sorted(JC.PRESETS))
def test_preset_json_matches_reference(name):
    j = JC.to_json(JC.PRESETS[name]())
    assert TC.to_json(TC.PRESETS[name]()) == j
    assert TC.to_json(TC.from_json(j)) == j


BAD_RENDER = [
    dict(width=100),                                   # does not tile
    dict(engine="raster"),
    dict(light_mode="sky"),
    dict(warp_march_rect=20),
    dict(warp_slab_vx=12),
    dict(warp_coarse=1),                               # needs pallas+fused
    dict(warp_pallas=True, warp_coarse=1),             # needs march rect
    dict(warp_pallas=True, warp_canvas_scale=0.1, warp_march_rect=32,
         warp_rect=128),
    dict(warp_pack=3),
    dict(warp_bands=0),
    dict(warp_bands=2),                                # needs engine=warp
]


@pytest.mark.parametrize("kw", BAD_RENDER, ids=lambda kw: ",".join(kw))
def test_validation_errors_match_reference(kw):
    with pytest.raises(ValueError) as ej:
        JC.SceneConfig(render=JC.RenderConfig(**kw))
    with pytest.raises(ValueError) as et:
        TC.SceneConfig(render=TC.RenderConfig(**kw))
    assert str(et.value) == str(ej.value)


def test_state_converters_round_trip(tiny_cfg):
    ref = jax.device_get(init_scene(tiny_cfg))
    st = state_from_numpy(ref, "cpu")
    assert st.volumes.dtype == torch.bfloat16
    assert st.base_key.dtype == torch.int64 and st.frame.dim() == 0
    back = state_to_numpy(st)
    for f in ref.particles._fields:
        a, b = getattr(ref.particles, f), getattr(back.particles, f)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert back.volumes.dtype == ref.volumes.dtype
    np.testing.assert_array_equal(np.asarray(back.volumes, np.float32),
                                  np.asarray(ref.volumes, np.float32))
    for f in ("frame", "spawn_carry", "time", "base_key"):
        a, b = np.asarray(getattr(ref, f)), getattr(back, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)


def test_camera_light_converters_round_trip(tiny_cfg):
    from volq.engine.loop import setup
    _, cam, light = setup(tiny_cfg)
    for nt, to, back in ((cam, camera_from_numpy, camera_to_numpy),
                         (light, light_from_numpy, light_to_numpy)):
        got = back(to(nt, "cpu"))
        for a, b in zip(nt, got):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_port_camera_matches_reference(tiny_cfg):
    from volq.core.camera import view_z
    from volq.scene.state import build_camera
    from volq_torch.core.camera import view_z as tview_z
    from volq_torch.scene.state import build_camera as tbuild
    c = tiny_cfg.camera
    ref = build_camera(c, 128, 64)
    got = tbuild(TC.CameraConfig(**dataclasses.asdict(c)), 128, 64, "cpu")
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    pos = np.random.default_rng(1).standard_normal((64, 3)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(view_z(ref, pos)),
                               tview_z(got, torch.from_numpy(pos)).numpy(),
                               rtol=0, atol=1e-6)


def test_import_pulls_in_no_jax():
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import volq_torch.engine, volq_torch.convert, "
            "volq_torch._build, volq_torch.profile, volq_torch.cli, "
            "volq_torch.probe.__main__, volq_torch.engine.checkpoint, "
            "volq_torch.engine.replay, volq_torch.engine.io\n"
            "bad = [m for m in set(sys.modules) - before if m == 'jax' "
            "or m.startswith('jax.') or m == 'volq' "
            "or m.startswith('volq.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_sources_name_no_jax_or_volq():
    files = sorted((REPO / "volq_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]
    pat = re.compile(r"^\s*(import|from)\s+(jax|volq)(\.|\s|$)")
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            assert not pat.match(line), f"{f}:{n}: {line}"
