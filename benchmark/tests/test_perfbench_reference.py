"""The plain reference against the port on the cells shrunk for the CPU,
its control, and a run whose timed path is broken underneath."""
import json

import numpy as np
import pytest
import torch

from benchmark import compare, reference
from benchmark.harness import run_cell
from benchmark.tools.control import control

FRAMES = 12


def _port(cell, seed):
    from volq_torch.engine import loop
    from volq_torch.render.warp import bake_slab_banks
    from volq_torch.scene.config import from_json
    from volq_torch.volume.lightbake import render_light_volumes
    from benchmark import spec
    scene = spec.scene(cell, seed)
    cfg = from_json(json.dumps(scene))
    st, cam, li = loop.setup(cfg, "cpu")
    lv = loop.cached_light_volumes(st, li, cfg)
    sb = loop.cached_slab_banks(st, lv, cfg)
    st, img, _ = loop.frames(st, cam, li, cfg, lv, sb, n=FRAMES)
    out = {"particles": reference.to_numpy(st.particles), "image": img}
    if cfg.volume.animated:
        light = render_light_volumes(st.volumes, li, cfg)
        out["banks"] = (st.volumes, light, bake_slab_banks(st.volumes,
                                                          light, cfg))
    return scene, out


@pytest.mark.parametrize("name", ["c3.steady", "c5.animated"])
def test_reference_matches_port(tiny_cell, name):
    cell = tiny_cell(name)
    scene, got = _port(cell, 77)
    rcfg = reference.as_config(scene)
    st = reference.replay(rcfg, FRAMES, "cpu")
    ref = reference.to_numpy(st.particles)
    for f in ref._fields:          # the sim follows the same fp32 steps
        np.testing.assert_array_equal(getattr(got["particles"], f),
                                      getattr(ref, f))
    vols = light = None
    if rcfg.volume.animated:
        vols, light, slabs = reference.banks(rcfg, st.time, "cpu")
        pv, pl, ps = got["banks"]
        assert torch.equal(pv, vols) and torch.equal(pl, light)
        assert torch.equal(ps[0], slabs[0]) and torch.equal(ps[1], slabs[1])
    H = rcfg.render.height
    rows = reference.render_rows(rcfg, ref, [(0, H)], "cpu", vols, light)
    d = np.abs(got["image"].numpy() - rows[0, H])
    # bf16 march: a rounding flip moves a pixel by a bf16 step or two
    assert d.max() <= 8 / 256 and d.mean() < 1e-3


def test_row_bands_equal_full_frame(tiny_cell):
    cell = tiny_cell("c5.animated")
    rcfg = reference.as_config(cell.config["scene"])
    st = reference.replay(rcfg, 4, "cpu")
    p = reference.to_numpy(st.particles)
    vols, light, _ = reference.banks(rcfg, st.time, "cpu")
    full = reference.render_rows(rcfg, p, [(0, 128)], "cpu", vols, light)
    part = reference.render_rows(rcfg, p, [(16, 24), (96, 104)], "cpu",
                                 vols, light)
    for (y0, y1), img in part.items():
        np.testing.assert_array_equal(img, full[0, 128][y0:y1])


@pytest.mark.parametrize("name", ["c3.steady", "c5.animated"])
def test_control_fails_the_limits(tiny_cell, name):
    cell = tiny_cell(name)
    vals = control(cell, 3, 40, "cpu")
    ok, _ = compare.judge(vals, cell.limits["limits"])
    assert not ok, vals


def _state_unchanged(state, cfg, group=None):
    return state


def _half_batch(fn):
    def render(particles, *a, **k):
        n = particles.pos.shape[0] // 2
        return fn(type(particles)(*(x[:n] for x in particles)), *a, **k)
    return render


def _image_altered(fn):
    def render(*a, **k):
        image, stats = fn(*a, **k)
        return image * 0.5, stats
    return render


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "image_altered"])
def test_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, fault):
    from volq_torch.engine import loop
    if fault == "state_unchanged":
        monkeypatch.setattr(loop, "sim_step", _state_unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(loop, "render_frame",
                            _half_batch(loop.render_frame))
    else:
        monkeypatch.setattr(loop, "render_frame",
                            _image_altered(loop.render_frame))
    res = run_cell(tiny_cell("c3.steady"), 11, 0.3, False, "cpu")
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["compared"].values())


@pytest.mark.gpu
def test_cells_correct_on_the_card(tiny_cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in ("c3.steady", "c5.animated"):
        res = run_cell(tiny_cell(name), 21, 1.0, False, "cuda")
        assert res["correct"], res["compared"]
