"""Spread of each end-to-end metric over sets of runs, by the check's own
statistic, beside each metric's bound in ``BENCHMARK.json``.

    python3 benchmark/tools/spread.py SET_A.jsonl [SET_B.jsonl]

Each file holds one set: one run a line, the run's result line under
``result`` (as ``sets.py`` writes) or the result line itself.  A spread is
the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median.  For
tightness the check leaves out each set's run farthest from the median
where that narrows the spread, and holds the mean of the two sets' spreads
to at most half the bound; for looseness it takes the wider spread of all
the runs, and a bound over eight times that is too loose.  Also printed:
the range of each set (less its farthest run where that narrows it), and
five times the widest spread, the bound the rule of five would give.
"""
from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def iqr(values):
    q = statistics.quantiles(values, n=4)
    return q[2] - q[0]


def less_farthest(values, stat):
    """``stat`` of the values without the one farthest from their median,
    where that is narrower."""
    if len(values) < 4:
        return stat(values)
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    rest = values[:far] + values[far + 1:]
    return min(stat(values), stat(rest))


def spreads(sets):
    """{metric: {...}} over the sets (lists of {metric: value})."""
    names = sorted({k for s in sets for run in s for k in run})
    out = {}
    for k in names:
        vals = [[run[k] for run in s if k in run] for s in sets]
        vals = [v for v in vals if len(v) >= 2]
        if not vals:
            continue
        med = statistics.median([x for v in vals for x in v])
        tight = [less_farthest(v, iqr) / statistics.median(v) for v in vals]
        loose = max(iqr(v) / statistics.median(v) for v in vals)
        rng = [less_farthest(v, lambda x: max(x) - min(x)) for v in vals]
        out[k] = {"median": med, "runs": [len(v) for v in vals],
                  "set_medians": [statistics.median(v) for v in vals],
                  "tight_spreads": tight,
                  "tight_mean": statistics.fmean(tight),
                  "loose_spread": loose, "ranges": rng,
                  "rule_of_five": 5 * max(tight + [loose])}
    return out


def read_set(path):
    runs = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        rec = json.loads(line)
        res = rec.get("result", rec) if "result" in rec else rec
        if not res or not res.get("metrics"):
            continue
        runs.append({k: v["value"] for k, v in res["metrics"].items()})
    return runs


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("sets", nargs="+")
    p.add_argument("--bench", default=str(ROOT / "BENCHMARK.json"))
    a = p.parse_args()
    bounds = {m["name"]: m.get("bound")
              for m in json.loads(Path(a.bench).read_text())["end_to_end"]}
    for k, s in spreads([read_set(f) for f in a.sets]).items():
        b = bounds.get(k)
        if b:
            s["bound"] = b
            s["tight_share_of_bound"] = s["tight_mean"] / b
            s["bound_over_loose"] = b / s["loose_spread"] \
                if s["loose_spread"] else None
        print(json.dumps({k: s}))


if __name__ == "__main__":
    main()
