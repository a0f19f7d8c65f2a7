"""Run a cell several times in a row, one process after another, as the
check does: each run's output goes to ``<out>.<i>.log`` and its last line
to ``<out>.jsonl``.

    python3 benchmark/tools/sets.py --workload c3.steady --seconds 40 \
        --seeds 11 12 13 --out chiprun_out/c3 [--trace 1]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

RUN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "run.py")


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", required=True)
    p.add_argument("--seeds", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--trace", default="0")
    a = p.parse_args()
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    for i, seed in enumerate(a.seeds):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, RUN, "--workload", a.workload,
                            "--seed", seed, "--seconds", a.seconds,
                            "--trace", a.trace], capture_output=True,
                           text=True)
        wall = time.perf_counter() - t
        with open(f"{a.out}.{i}.log", "w") as f:
            f.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
        lines = r.stdout.strip().splitlines()
        last = lines[-1] if lines else ""
        try:
            res = json.loads(last)
        except json.JSONDecodeError:
            res = None
        rec = {"workload": a.workload, "seed": seed, "rc": r.returncode,
               "wall_s": wall, "trace": a.trace, "result": res}
        with open(f"{a.out}.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
        m = res["metrics"] if res else {}
        print(json.dumps({"seed": seed, "rc": r.returncode,
                          "wall_s": round(wall, 1),
                          "correct": res and res["correct"],
                          "metrics": {k: v["value"] for k, v in m.items()}}),
              flush=True)
        if r.returncode:
            print(r.stderr[-3000:], flush=True)


if __name__ == "__main__":
    main()
