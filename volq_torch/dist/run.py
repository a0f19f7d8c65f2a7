"""Starting the ranks of a mesh: ``launch`` runs a function on one
spawned process per rank (``torch.multiprocessing``, start method
``spawn``), joined into one process group, and returns what rank 0
returned.  The rank functions live with their callers
(``engine/loop.py``, ``cli.py``); a rank process imports this package
and the caller's module, nothing else of the caller's process."""
from __future__ import annotations

import os
import pickle
import tempfile

import torch.distributed as dist
import torch.multiprocessing as mp

from volq_torch.dist.mesh import Mesh, join


def _entry(rank: int, mesh: Mesh, init_method: str, fn, args, out: str):
    device = join(mesh, rank, init_method)
    try:
        result = fn(rank, mesh, device, *args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def launch(mesh: Mesh, fn, *args):
    """Run ``fn(rank, mesh, device, *args)`` on ``mesh.size`` spawned
    processes joined into one process group; returns rank 0's result.
    ``fn`` and ``args`` must pickle (``fn`` a module-level function).
    The ranks meet at a file in a temporary directory of this launch's
    own, so concurrent launches never share a rendezvous.  Raises when
    a rank fails (the others are terminated)."""
    with tempfile.TemporaryDirectory(prefix="volq_mesh_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        out = os.path.join(tmp, "rank0.pkl")
        mp.spawn(_entry, args=(mesh, init_method, fn, args, out),
                 nprocs=mesh.size, join=True, start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)
