"""The numbers that decide ``correct``: the program's outputs against the
reference's, each held to its limit from ``limits/<workload>.json``.

Outputs are a dict: ``particles`` (sim.Particles of numpy arrays),
``rows`` ({(y0, y1): image rows}) and, for an animated scene, ``volumes``,
``light`` (or None) and ``slabs`` (density, light or None), as numpy.
"""
from __future__ import annotations

import random

import numpy as np

_STATE = ("pos", "vel", "age", "lifetime", "size", "albedo")


def bands(seed, height, n, rows):
    """``n`` distinct row bands of ``rows`` rows, drawn from the seed."""
    starts = random.Random(int(seed)).sample(range(0, height - rows + 1,
                                                   rows), n)
    return sorted((y0, y0 + rows) for y0 in starts)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def numbers(got, ref):
    """{name: value}, every one of them lower-is-better."""
    gp, rp = got["particles"], ref["particles"]
    out = {
        # the widest gap of any float particle attribute, in its own units
        "state_err": max(float(np.abs(np.asarray(getattr(gp, f), np.float64)
                                      - getattr(rp, f)).max())
                         for f in _STATE),
        # slots whose volume entry or liveness differ: exact
        "slots_differ": int(((gp.vol_idx != rp.vol_idx)
                             | ((gp.age < gp.lifetime)
                                != (rp.age < rp.lifetime))).sum()),
    }
    d = np.concatenate([(got["rows"][k] - ref["rows"][k]).reshape(-1)
                        for k in ref["rows"]])
    out["image_max_err"] = float(np.abs(d).max())
    out["image_rms_err"] = float(np.sqrt(np.mean(d * d)))
    if "volumes" in ref:
        out["volume_err"] = float(np.abs(got["volumes"].astype(np.float64)
                                         - ref["volumes"]).max())
        if ref["light"] is not None:
            out["light_err"] = _rel(got["light"], ref["light"])
        out["slab_err"] = max(_rel(g, r) for g, r in
                              zip(got["slabs"], ref["slabs"])
                              if r is not None)
    return out


def judge(values, limits):
    """(correct, {name: {"value", "limit"}}) -- a number without a limit,
    or a limit without its number, is not correct."""
    compared = {k: {"value": values.get(k), "limit": limits.get(k)}
                for k in sorted(set(values) | set(limits))}
    ok = all(c["value"] is not None and c["limit"] is not None
             and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
