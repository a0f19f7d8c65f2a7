"""Deterministic replay (counterpart of ``volq/engine/replay.py``).

Every frame is a function of (config, base seed, frame index): the sim is
threefry-keyed by the frame counter and the bakes are pure, so any frame
can be recomputed alone, from nothing or from any checkpoint.
"""
from __future__ import annotations

from volq_torch.engine.loop import setup, frame
from volq_torch.scene.config import SceneConfig
from volq_torch.sim.step import sim_step


def replay_frame(cfg: SceneConfig, frame_idx: int, device=None):
    """Recompute frame ``frame_idx`` (0-based: the image of the
    (frame_idx + 1)-th call to ``engine.loop.frame``) from scratch.
    Returns (state_after, image, stats)."""
    state, camera, light = setup(cfg, device)
    for _ in range(frame_idx):
        state = sim_step(state, cfg)
    # the sim part of ``frame`` advances once more, to frame_idx + 1
    return frame(state, camera, light, cfg)
