"""Shared helpers of the benchmark's tests: the cells, shrunk to a size
the CPU renders in seconds (every render flag of the preset kept).
``c3.steady`` is built from its files (configs/c3.json, traffic/steady.json,
limits/c3.steady.json) though BENCHMARK.json does not list it yet."""
import json

import pytest

from benchmark import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
FILES = {"c3.steady": dict(name="c3.steady", config="c3", traffic="steady",
                           chips=1, why="the sim's cell, not yet listed")}


def cell(name):
    if name in FILES:
        w = FILES[name]
        return spec.make_cell(w, f"{spec.HERE.name}/configs/{w['config']}"
                              ".json", BENCH)
    return spec.load_cell(name)

SHRINK = {
    "c3": dict(n_particles=64, volume=dict(size=32, bank_size=64),
               render=dict(width=256, height=128, warp_rect=48,
                           warp_march_rect=32, warp_slab_vx=16)),
    "c5": dict(n_particles=256, volume=dict(size=32, bank_size=16),
               render=dict(width=256, height=128, warp_rect=48,
                           warp_march_rect=32, steps=12)),
}


def shrink(cell):
    s = cell.config["scene"]
    for k, v in SHRINK[cell.workload["config"]].items():
        if isinstance(v, dict):
            s[k].update(v)
        else:
            s[k] = v
    return cell


@pytest.fixture
def tiny_cell():
    return lambda name: shrink(cell(name))
