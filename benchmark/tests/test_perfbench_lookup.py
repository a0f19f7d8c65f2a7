"""A cell, its traffic mix, its configuration and each per-layer metric are
found by the names in BENCHMARK.json: adding one is adding files."""
import json
import shutil

import pytest

from benchmark import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_committed_cells_load(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert {"bands", "band_rows", "limits"} <= set(cell.limits)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer
    scene = spec.scene(cell, 5)
    assert scene["volume"]["animated"] == \
        cell.traffic["scene"]["volume.animated"]


def test_added_files_are_found(tmp_path):
    # a new config, mix, cell and metric, as files and entries only
    root = tmp_path
    shutil.copytree(spec.HERE, root / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = root / spec.HERE.name
    bench = json.loads(json.dumps(BENCH))
    c3 = json.loads((here / "configs" / "c3.json").read_text())
    c3["name"] = "c3b"
    c3["scene"]["render"]["warp_rect"] = 160
    (here / "configs" / "c3b.json").write_text(json.dumps(c3))
    (here / "traffic" / "burst.json").write_text(json.dumps(
        {"why": "x", "scene": {"emitter.rate": 512.0}, "cache_banks": True,
         "frames_per_call": 2}))
    (here / "limits" / "c3b.burst.json").write_text(json.dumps(
        {"bands": 2, "band_rows": 8, "limits": {"state_err": 1.0}}))
    (here / "metrics" / "frames.seen.py").write_text(
        "def read(ctx):\n    return ctx['frames']\n")
    bench["configs"].append({"name": "c3b", "source": "x",
                             "file": f"{spec.HERE.name}/configs/c3b.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "c3b.burst", "config": "c3b",
                               "traffic": "burst", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames.seen", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "frame loop", "moves": "frame_ms",
                               "workloads": ["c3b.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("c3b.burst", root)
    assert cell.traffic["frames_per_call"] == 2
    assert cell.limits["bands"] == 2
    scene = spec.scene(cell, 9)
    assert scene["emitter"]["rate"] == 512.0
    assert scene["render"]["warp_rect"] == 160
    assert "frames.seen" in {m["name"] for m in cell.per_layer}
    assert "bake.ms" not in {m["name"] for m in cell.per_layer}
    assert spec.metric_reader("frames.seen", root)({"frames": 3}) == 3
    with pytest.raises(KeyError):
        spec.load_cell("c3b.none", root)
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no.such", root)


def test_traffic_key_must_exist():
    cell = spec.load_cell(BENCH["workloads"][0]["name"])
    cell.traffic = dict(cell.traffic, scene={"render.no_such_key": 1})
    with pytest.raises(KeyError):
        spec.scene(cell, 1)


def test_seeds_repeat_and_differ():
    assert spec.run_seeds(2 ** 40 + 3) == spec.run_seeds(2 ** 40 + 3)
    assert spec.run_seeds(1) != spec.run_seeds(2)
    s, v = spec.run_seeds(2 ** 62)
    assert 0 <= s < 2 ** 31 and 0 <= v < 2 ** 30
