"""Kernel A's device time as built from other source trees beside this
tree's, on the same inputs, in turns.

    python3 -m volq_torch.compare_builds DIR [DIR ...]

Each DIR is the root of a checkout of this repository (e.g. a parent
commit unpacked with ``git archive``) whose ``warp_march_launch`` takes
the arguments this tree's wrapper passes.  Builds ``csrc/warp_march.cu``
of this tree and of each DIR (one ``nvcc`` each, all started together),
prints each library's path (for ``cuobjdump``), then for each path that
launches A -- c1 under the warp engine's Pallas path, c2, c3, c4
center-lit and per-step lit, c5, each set up at full size on the card --
holds every build's planes and clamp count equal to this tree's and
times every build in ROUNDS rounds, in turns (the order reversed every
other round): device ms per launch replayed from a CUDA graph, as
``chip_smoke.py``'s ``device_ms``.  Prints per path and build the rounds'
min, median and max, with the card's name and power limit.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import statistics
import subprocess
from pathlib import Path

import torch

from volq_torch import _build

NAME = "warp_march"
ROUNDS = 6


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _graph_ms(fn, reps: int = 20) -> float:
    """Device ms per call of ``fn`` replayed from a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # relaxed: kernel A's launch sets its shared-memory attribute
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def build(roots) -> dict:
    """{label: loaded library of A} for this tree ("tree") and each root,
    built with one nvcc each, all started together."""
    csrc = {"tree": _build.CSRC}
    csrc.update({str(r): Path(r).resolve() / "volq_torch" / "csrc"
                 for r in roots})
    jobs = {}
    for label, path in csrc.items():
        _build.CSRC = path
        jobs[label] = _build._start(NAME, False)
    libs = {}
    for label, path in csrc.items():
        _build.CSRC = path
        if jobs[label] is not None:
            _build._finish(NAME, jobs[label], False)
        lib = _build._lib_path(NAME)
        print(f"[compare] build {label}: {lib}")
        libs[label] = ctypes.CDLL(str(lib))
    _build.CSRC = csrc["tree"]
    return libs


def _presets():
    from volq_torch.scene import config as C

    def render(cfg, **kw):
        return dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, **kw))
    return {"c1 warp": render(C.c1(), engine="warp", warp_pallas=True),
            "c2": C.c2(), "c3": C.c3(), "c4": C.c4(),
            "c4 per-step": render(C.c4(), light_mode="march"), "c5": C.c5()}


def march_inputs(cfg):
    """A's inputs for the first frame of ``cfg``'s scene, on the card."""
    from volq_torch.engine import loop
    from volq_torch.render.warp import bake_slab_banks, fused_inputs
    from volq_torch.sim.step import sim_step
    state, camera, light = loop.setup(cfg)
    state = sim_step(state, cfg)
    lv = loop._light_volumes(state, light, cfg)
    bank, lbank = bake_slab_banks(state.volumes, lv, cfg)
    march, _, _ = fused_inputs(state.particles, camera, light, cfg, bank, 0,
                               cfg.render.height, lbank)
    return march


def _use(lib: ctypes.CDLL) -> None:
    """Make ``lib`` the library A's next launches call (rebinding them)."""
    _build._libs[NAME] = lib
    _build._bound.clear()


def compare(libs: dict, card: str) -> dict:
    """{path: {label: [ms a round]}}, printed as it goes."""
    from volq_torch.render import kernel as K
    out = {}
    labels = list(libs)
    for tag, cfg in _presets().items():
        march = march_inputs(cfg)
        ref = None
        for label in labels:
            _use(libs[label])
            got = K.warp_march(*march)
            if ref is None:
                ref = got
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
                f"{tag}: build {label} differs from this tree's"
        ms = {label: [] for label in labels}
        for r in range(ROUNDS):
            for label in labels if r % 2 == 0 else labels[::-1]:
                _use(libs[label])
                ms[label].append(_graph_ms(lambda: K.warp_march(*march)))
        for label in labels:
            v = ms[label]
            print(f"[compare] {tag} warp_march {label}: min {min(v):.4f} "
                  f"median {statistics.median(v):.4f} max {max(v):.4f} ms "
                  f"({ROUNDS} rounds)  [{card}]")
        out[tag] = ms
        del march
        torch.cuda.empty_cache()
    _use(libs["tree"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkouts to compare with")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_builds: torch sees no CUDA device")
    card = _card()
    print(f"[card] {card}")
    compare(build(a.roots), card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
