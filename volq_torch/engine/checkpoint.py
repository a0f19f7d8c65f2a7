"""Checkpoint / resume (counterpart of ``volq/engine/checkpoint.py``).

A checkpoint is the state's leaves plus the config JSON in one ``.npz``,
key for key the JAX package's schema (``p_<field>`` for every particle
field, ``volumes`` widened to fp32, ``frame``, ``spawn_carry``, ``time``,
``base_key`` as uint32[2], ``config``), so a file written by either
package loads in the other.  The sim is keyed on the frame counter, so a
restore is frame-exact: K frames from a restored state equal K frames
without the round trip.
"""
from __future__ import annotations

import numpy as np

from volq_torch.convert import state_from_numpy, state_to_numpy
from volq_torch.core.device import resolve_device
from volq_torch.core.types import Particles, SceneState
from volq_torch.scene.config import SceneConfig, to_json, from_json

_STATE_SCALARS = ("frame", "spawn_carry", "time", "base_key")


def save_state(path: str, state: SceneState, cfg: SceneConfig):
    host = state_to_numpy(state, bank_fp32=True)
    arrays = {f"p_{f}": getattr(host.particles, f)
              for f in Particles._fields}
    arrays["volumes"] = host.volumes
    for f in _STATE_SCALARS:
        arrays[f] = getattr(host, f)
    np.savez(path, config=to_json(cfg), **arrays)


def load_state(path: str, device=None):
    """Returns (state, cfg) with the state on ``device`` (the CUDA card
    when None; raises when there is none).  The bank goes back to bf16."""
    device = resolve_device(device)
    z = np.load(path, allow_pickle=False)
    cfg = from_json(str(z["config"]))
    host = SceneState(
        particles=Particles(**{f: z[f"p_{f}"] for f in Particles._fields}),
        volumes=z["volumes"],
        **{f: z[f] for f in _STATE_SCALARS})
    return state_from_numpy(host, device), cfg
