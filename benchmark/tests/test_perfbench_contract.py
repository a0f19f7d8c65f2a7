"""The command line, BENCHMARK.json's shape, and the result line's keys."""
import json
import re

import pytest

from benchmark import run, spec
from benchmark.harness import run_cell

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_command_line():
    a = run._args(["--workload", "c3.steady", "--seed", str(2 ** 31 + 7),
                   "--seconds", "40", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == \
        ("c3.steady", 2 ** 31 + 7, 40.0, 1)
    with pytest.raises(SystemExit):
        run._args(["--workload", "c3.steady", "--seed", "1",
                   "--seconds", "4", "--trace", "2"])


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        spec.metric_reader(m["name"])
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])


def test_no_card_no_result(capsys):
    # without a card the run exits non-zero and prints no result line
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "c5.animated", "--seed", "1",
                     "--seconds", "1"]) != 0
    out = capsys.readouterr().out.strip().splitlines()
    assert not out or not out[-1].startswith("{")


def test_forbidden_modules_by_whole_name():
    mods = {"volq_torch": 0, "volq_torch.engine.loop": 0, "numpy": 0,
            "jaxlib.xla": 0}
    assert run.forbidden_modules(mods) == ["jaxlib"]
    assert run.forbidden_modules({"volq.render": 0}) == ["volq"]
    assert run.forbidden_modules({"volq_torch": 0, "jax_like": 0}) == []


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_result_line_keys(tiny_cell, trace):
    cell = tiny_cell("c3.steady")
    res = run_cell(cell, 2 ** 33 + 5, 0.3, trace, "cpu")
    assert list(res)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["correct"] is True and res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(res)
    want = {m["name"] for m in (cell.per_layer if trace else
                                cell.end_to_end)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert {"window_s", "busy_s"} <= set(res["device"])
        assert {"sim.ms", "render.ms"} <= set(res["metrics"])
    for c in res["compared"].values():
        assert set(c) == {"value", "limit"}


def test_benchmark_files_alone_give_no_result(tmp_path):
    # a directory with only BENCHMARK.json and the benchmark's paths
    import shutil
    import subprocess
    import sys
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(spec.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, *BENCH["command"][1:], "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "3",
                        "--seconds", "1"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    lines = r.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")
