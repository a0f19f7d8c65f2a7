"""The sharded frame on ``torch.distributed`` (counterpart of
``volq/dist/``): ``mesh.py`` (ranks, devices, backend), ``sharded.py``
(the frame step of one rank) and ``run.py`` (spawning the ranks)."""
from volq_torch.dist.mesh import Mesh, make_mesh
from volq_torch.dist.run import launch
from volq_torch.dist.sharded import (check_mesh, gather_state, shard_state,
                                     sharded_frame_fn)

__all__ = ["Mesh", "make_mesh", "launch", "check_mesh", "sharded_frame_fn",
           "shard_state", "gather_state"]
