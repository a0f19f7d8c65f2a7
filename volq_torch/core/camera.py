"""Camera construction (mirror of ``volq/core/camera.py``).

``make_camera`` is host numpy math, copied from the JAX package so both
build bit-identical fp32 camera vectors; callers move the result onto a
device with ``to_device``.  ``pixel_rays`` generates pinhole-perspective
and orthographic rays on the camera's device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from volq_torch.core.device import scalar
from volq_torch.core.types import Camera


def make_camera(eye, look_at, up_hint, *, fov_y_deg=45.0, aspect=1.0,
                ortho_half_h=1.0, projection="persp") -> Camera:
    """Numeric camera state on the host (numpy fp32 leaves).  ``aspect``
    = W / H; perspective scale_y = tan(fov_y/2), ortho scale_y =
    ortho_half_h; scale_x = scale_y * aspect."""
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(look_at, np.float32) - eye
    fwd = fwd / np.linalg.norm(fwd)
    up_hint = np.asarray(up_hint, np.float32)
    right = np.cross(fwd, up_hint)
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    if projection == "persp":
        sy = math.tan(math.radians(fov_y_deg) * 0.5)
        sx = sy * aspect
    elif projection == "ortho":
        sy = float(ortho_half_h)
        sx = sy * aspect
    else:
        raise ValueError(f"unknown projection {projection!r}")
    return Camera(eye=eye, right=right, up=up, fwd=fwd,
                  scale_x=np.float32(sx), scale_y=np.float32(sy))


def to_device(nt, device):
    """A Camera/Light of numpy leaves -> the same NamedTuple of fp32
    tensors on ``device``."""
    return type(nt)(*(torch.as_tensor(np.asarray(v, np.float32),
                                      device=device) for v in nt))


def pixel_rays(camera: Camera, px, py, width: int, height: int,
               projection: str):
    """Per-pixel world rays.  px / py: integer pixel coordinate tensors of
    any (broadcast-compatible) shape; returns (origin, direction) with a
    trailing [..., 3] axis.  Pixel (px, py) samples its centre; image y
    grows downward.  Directions are unit length, so march t is in world
    units."""
    ndc_x = (px.to(torch.float32) + 0.5) / scalar(width, camera.eye) \
        * 2.0 - 1.0
    ndc_y = 1.0 - (py.to(torch.float32) + 0.5) / scalar(height, camera.eye) \
        * 2.0
    ox = ndc_x * camera.scale_x
    oy = ndc_y * camera.scale_y
    if projection == "persp":
        d = (camera.fwd + ox[..., None] * camera.right
             + oy[..., None] * camera.up)
        d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
        o = camera.eye.expand(d.shape)
    else:
        o = (camera.eye + ox[..., None] * camera.right
             + oy[..., None] * camera.up)
        d = camera.fwd.expand(o.shape)
    return o, d


def view_z(camera: Camera, pos):
    """Signed depth of world points [..., 3] along the camera forward."""
    rel = pos - camera.eye
    f = camera.fwd
    return rel[..., 0] * f[0] + rel[..., 1] * f[1] + rel[..., 2] * f[2]
