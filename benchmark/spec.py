"""A cell's files, found by the names in ``BENCHMARK.json``.

Nothing here is particular to a cell: a workload names a configuration
(``configs/<config>.json`` through the configuration's ``file``) and a
traffic mix (``traffic/<traffic>.json``); its comparison settings and
limits are ``limits/<workload>.json``; each per-layer metric is read by
``metrics/<metric>.py``.
"""
from __future__ import annotations

import copy
import hashlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict       # the configuration's file
    traffic: dict      # the traffic mix's file
    limits: dict       # the comparison's settings and limits
    end_to_end: list   # BENCHMARK.json's end-to-end metrics of this cell
    per_layer: list    # ... and its per-layer metrics


def _applies(metric, name, moves_reported):
    if "workloads" in metric:
        return name in metric["workloads"]
    return moves_reported is None or metric["moves"] in moves_reported


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``root``'s BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return make_cell(w, cfg["file"], bench, root)


def make_cell(workload: dict, config_file: str, bench: dict,
              root: Path = ROOT) -> Cell:
    """A cell from its workload entry, its configuration's file and the
    metrics of ``bench``; the traffic and limits files by name."""
    name = workload["name"]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, None)]
    reported = {m["name"] for m in e2e}
    here = root / HERE.name
    return Cell(
        name=name, workload=workload,
        config=json.loads((root / config_file).read_text()),
        traffic=json.loads((here / "traffic" / f"{workload['traffic']}.json")
                           .read_text()),
        limits=json.loads((here / "limits" / f"{name}.json").read_text()),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"]
                   if _applies(m, name, reported)])


def run_seeds(seed: int) -> tuple[int, int]:
    """--seed (any whole number) -> (scene seed, volume seed): the same
    seed gives the same particles and the same volume bank."""
    h = hashlib.sha256(str(int(seed)).encode()).digest()
    return (int.from_bytes(h[:4], "little") & 0x7FFFFFFF,
            int.from_bytes(h[4:8], "little") & 0x3FFFFFFF)


def scene(cell: Cell, seed: int) -> dict:
    """The scene configuration a run uses: the configuration's scene, the
    traffic's overrides (dotted keys), and the seeds from ``seed``."""
    d = copy.deepcopy(cell.config["scene"])
    for key, value in cell.traffic.get("scene", {}).items():
        *path, last = key.split(".")
        node = d
        for p in path:
            node = node[p]
        if last not in node:
            raise KeyError(f"traffic {cell.workload['traffic']!r} sets "
                           f"unknown key {key!r}")
        node[last] = value
    d["seed"], d["volume"]["seed"] = run_seeds(seed)
    return d


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"per-layer metric {name!r} has no reader "
                                f"at {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
