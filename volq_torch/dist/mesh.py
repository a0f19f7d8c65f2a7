"""Process meshes for the sharded frame (counterpart of
``volq/dist/mesh.py``).

The engine's only cross-device axis is data-parallel: screen tiles (or,
on the warp engine, depth slices) for the render and particle slots for
the sim.  One rank per device, one process per rank, joined into one
``torch.distributed`` process group: NCCL across CUDA cards, gloo across
CPU processes.  The backend follows the device; neither ever stands in
for the other.
"""
from __future__ import annotations

from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

from volq_torch.core.device import resolve_device

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# how long a collective waits for the other ranks before it fails
_TIMEOUT = timedelta(minutes=10)


class Mesh(NamedTuple):
    """``size`` ranks on ``device`` ("cuda": rank r on card r; "cpu")
    over ``backend``."""

    size: int
    device: str
    backend: str


def make_mesh(n_devices: int, device=None) -> Mesh:
    """A mesh of ``n_devices`` ranks on ``device`` (None: the CUDA cards,
    raising without them).  Raises ValueError when the host has fewer
    cards than ranks."""
    dev = resolve_device(device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {dev}")
    if n_devices < 1:
        raise ValueError(f"mesh size must be >= 1, got {n_devices}")
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if have < n_devices:
            raise ValueError(f"need {n_devices} devices, have {have}")
    return Mesh(n_devices, dev.type, _BACKENDS[dev.type])


def join(mesh: Mesh, rank: int, init_method: str) -> torch.device:
    """Join this process to ``mesh`` as ``rank`` through the rendezvous
    ``init_method``; returns its device (card ``rank`` on a CUDA mesh).
    A CPU rank runs one intra-op thread (the ranks share the host's
    cores)."""
    if mesh.device == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(mesh.backend, init_method=init_method,
                            world_size=mesh.size, rank=rank,
                            timeout=_TIMEOUT)
    return device
