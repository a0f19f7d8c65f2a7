"""On-card probes (counterparts of the JAX package's TPU probes under
``bench/``): three small hand-written CUDA kernels that each price one
hardware mechanism the warp engine's kernels are built on, so that their
redesign can start from the card's own numbers.

* ``tensor_core.mma_probe`` (``csrc/probe_mma.cu``, replaces
  ``bench/mxu_probe.py:time_shape``): small bf16 products on one SM's tensor
  cores, chained or pipelined -- the hat-matrix placement as a product --
  by ``mma.sync`` or by ``wgmma`` on TMA-loaded operands;
* ``stage.stage_probe`` (``csrc/probe_stage.cu``, replaces
  ``bench/specs_probe.py:run``): the fixed cost per step of a sequential
  loop that stages tiles through shared memory, with ``cp.async`` or with
  TMA bulk copies into an mbarrier ring;
* ``window.window_probe`` (``csrc/probe_window.cu``, replaces
  ``bench/granule_probe.py:run``): an ordered read-modify-write of canvas
  windows at offsets of different alignment, a block per 8-row band, by
  16-byte ``cp.async`` or by TMA loads and stores at element offsets.

Each wrapper launches its kernel for tensors on the card (raising if it
cannot) and runs its plain PyTorch version only for tensors on the CPU;
``_build.launches`` counts the launches by arm, each arm being its own C
function (``probe_mma_launch`` / ``probe_mma_wgmma_launch``,
``probe_stage_launch`` / ``probe_stage_tma_launch``,
``probe_window_launch`` / ``probe_window_tma_launch``).
``python -m volq_torch.probe`` runs the timed sweeps on the card.
"""
from __future__ import annotations

import torch

from volq_torch.probe.stage import stage_probe, stage_probe_plain
from volq_torch.probe.tensor_core import mma_probe, mma_probe_plain
from volq_torch.probe.window import window_probe, window_probe_plain


def median_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` of the device milliseconds of one call of
    ``fn`` (after one warm-up call), replayed from a CUDA graph: the
    kernel's own time, without the host work of the Python wrapper that
    launches it (checks, plan, ctypes, shared-memory attribute)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # relaxed: the launchers set their kernel's shared-memory attribute
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    del graph
    return sorted(ts)[len(ts) // 2]


__all__ = ["mma_probe", "mma_probe_plain", "stage_probe",
           "stage_probe_plain", "window_probe", "window_probe_plain",
           "median_ms"]
