"""Opacity envelopes shared by the renderers (mirror of
``volq/render/xla_render.py:_fade, _near_fade``)."""
from __future__ import annotations

import torch

from volq_torch.core.device import scalar


def _fade(tau, fade_in, fade_out):
    """Lifetime fade-in/out envelope of tau = age / lifetime."""
    fi = max(float(fade_in), 1e-6)
    fo = max(float(fade_out), 1e-6)
    return torch.clamp(torch.minimum(tau / scalar(fi, tau),
                                     (1.0 - tau) / scalar(fo, tau)),
                       0.0, 1.0)


def _near_fade(view_z, r):
    """Camera-proximity fade: opacity ramps 0 -> 1 between view depths
    near_fade_end and near_fade_start; 1.0 when near_fade_start <= 0."""
    if r.near_fade_start <= 0.0:
        return 1.0
    span = max(r.near_fade_start - r.near_fade_end, 1e-6)
    return torch.clamp((view_z - r.near_fade_end) / scalar(span, view_z),
                       0.0, 1.0)
