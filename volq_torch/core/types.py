"""Core state types of the port (mirror of ``volq/core/types.py``).

NamedTuples of torch tensors.  Static configuration lives in
``volq_torch.scene.config``.  ``SceneState.base_key`` is the jax-style
threefry key: two uint32 words held in an int64 tensor of shape [2]
(torch has no full uint32 arithmetic; see ``volq_torch.sim.prng``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    """Numeric camera state (fp32 tensors).  ``scale_x/scale_y`` are
    tan(half-fov) per axis for perspective; ``right/up/fwd`` form an
    orthonormal basis; image y grows downward."""

    eye: torch.Tensor      # [3] f32
    right: torch.Tensor    # [3] f32
    up: torch.Tensor       # [3] f32
    fwd: torch.Tensor      # [3] f32
    scale_x: torch.Tensor  # [] f32
    scale_y: torch.Tensor  # [] f32


class Light(NamedTuple):
    """Directional light; ``direction`` points toward the light."""

    direction: torch.Tensor  # [3] f32
    color: torch.Tensor      # [3] f32
    ambient: torch.Tensor    # [3] f32


class Particles(NamedTuple):
    """Structure-of-arrays particle state.  Alive iff ``age < lifetime``;
    ``size`` is the half-extent of the cubic AABB; ``vol_idx`` selects a
    volume of the bank."""

    pos: torch.Tensor       # [N,3] f32
    vel: torch.Tensor       # [N,3] f32
    age: torch.Tensor       # [N]   f32
    lifetime: torch.Tensor  # [N]   f32
    size: torch.Tensor      # [N]   f32
    albedo: torch.Tensor    # [N,3] f32
    vol_idx: torch.Tensor   # [N]   i32


class SceneState(NamedTuple):
    """Everything that evolves frame to frame; deterministic given
    (config, key, frame)."""

    particles: Particles
    volumes: torch.Tensor      # [M,V,V,V] density bank, bf16 storage
    frame: torch.Tensor        # [] i32 frame counter
    spawn_carry: torch.Tensor  # [] f32 fractional emission budget
    time: torch.Tensor         # [] f32 simulation time in seconds
    base_key: torch.Tensor     # [2] int64 holding the uint32 threefry key
