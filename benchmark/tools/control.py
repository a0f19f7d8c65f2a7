"""The comparison's control: the reference put in the program's place and
computed in the precision below the configuration's (sim state in bfloat16
for fp32; banks and stored march tensors in float8 e4m3 for bfloat16; the
light sweep in bfloat16 for fp32), judged by the same numbers as a run.

    python3 benchmark/tools/control.py --workload c3.steady --seed 7 \
        --frames 1000

``--frames``: the sim steps a run of the cell makes (its ``[reference]``
line says).  Prints one JSON line per seed: the numbers, and whether the
cell's limits would pass them (they must not).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _np(t):
    return None if t is None else t.float().cpu().numpy()


def control(cell, seed, frames, device):
    """{name: value} of the lower-precision reference against the
    reference, on the run's rows."""
    import torch
    from benchmark import compare, reference, spec
    scene = spec.scene(cell, seed)
    rcfg = reference.as_config(scene)
    rows = compare.bands(seed, rcfg.render.height, cell.limits["bands"],
                         cell.limits["band_rows"])
    out = []
    for lowp in (False, True):
        st = reference.replay(rcfg, frames, "cpu", lowp,
                              force_device=device)
        o = {"particles": reference.to_numpy(st.particles)}
        vols = light = None
        if rcfg.volume.animated:
            vols, light, slabs = reference.banks(rcfg, st.time.to(device),
                                                 device, lowp)
            o.update(volumes=_np(vols), light=_np(light),
                     slabs=tuple(_np(s) for s in slabs))
        o["rows"] = reference.render_rows(
            rcfg, o["particles"], rows, device, vols, light, lowp,
            workers=len(os.sched_getaffinity(0)))
        out.append(o)
        del vols, light
        if device != "cpu":
            torch.cuda.empty_cache()
    return compare.numbers(out[1], out[0])


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    from benchmark import compare, spec
    cell = spec.load_cell(a.workload)
    for seed in a.seed:
        t = time.perf_counter()
        vals = control(cell, seed, a.frames, a.device)
        ok, _ = compare.judge(vals, cell.limits["limits"])
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "frames": a.frames, "control": vals,
                          "passes_limits": ok,
                          "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
