"""Least time of kernels A (``warp_march``) and B (``warp_composite``) on a
frame, from the configuration and the reference's own geometry alone.

The counts read no plan and no tensor of the program: which particles are
valid, which volume entries they use and which canvas cells their
placements cover come from ``reference.warp.geometry``.  Each input byte is
counted once and each output byte once; operations are the fp32 work per
valid ray (12 a step on the telescoped march, about 80 for the ray-box
test, the fan shift and the exps, 20 more for the centre light sample; 70
a step and 120 more lit per step) and per covered canvas cell and plane
pair (30 unlit, 52 lit; 44 / 76 with the interleaved channels).

Peaks: NVIDIA's data sheet for the H100 SXM, fp32 outside the tensor cores
and HBM3 bandwidth.
"""
from __future__ import annotations

import numpy as np

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

_SCALARS = 64       # bytes of per-particle scalars a kernel reads


def least_s(nbytes, flops):
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def _modes(cfg):
    r = cfg.render
    lit = r.light_steps > 0
    center = lit and r.light_mode == "center"
    return lit, center


def march_work(cfg, geo, vx, V):
    """(bytes, flops) of kernel A on one frame's geometry: the marching
    slabs of the distinct entries the valid particles use, their scalars
    and ray coordinates in, their march-resolution planes out."""
    from .reference.warp import march_rect
    r = cfg.render
    lit, center = _modes(cfg)
    S, RM = r.steps, march_rect(cfg)
    item = 4 if r.warp_fp32 else 2
    valid = geo["valid"]
    nv = int(valid.sum())
    entries = int(np.unique(np.asarray(geo["vol_idx"])[valid]).size)
    light_slabs = 0 if not lit else (1 if center else S)
    npl = 2 if lit else 1
    nbytes = (entries * (S + light_slabs) * vx * V * item
              + nv * (_SCALARS + 2 * RM * 4) + nv * npl * RM * RM * 4)
    per_ray = (12 * S + 80 if not lit else
               12 * S + 100 if center else 70 * S + 120)
    return nbytes, nv * RM * RM * per_ray


def composite_work(cfg, geo):
    """(bytes, flops) of kernel B on one frame's geometry: the canvas cells
    some valid placement covers, read and written, the planes read, the
    scalars; operations per covered cell."""
    from .reference.warp import march_rect
    r = cfg.render
    lit, _ = _modes(cfg)
    npl = 2 if lit else 1
    RM = march_rect(cfg)
    valid = geo["valid"]
    nv = int(valid.sum())
    y0, y1 = geo["cy0"][valid], geo["cy1"][valid]
    x0, x1 = geo["cx0"][valid], geo["cx1"][valid]
    ok = (y1 > y0) & (x1 > x0)
    y0, y1, x0, x1 = y0[ok], y1[ok], x0[ok], x1[ok]
    g = geo["geom"]
    hc = g.pad + g.hc_img + g.sup + 2
    wc = g.pad + g.wc_img + g.sup + 2
    diff = np.zeros((hc + 1, wc + 1), np.int64)
    np.add.at(diff, (y0, x0), 1)
    np.add.at(diff, (y0, x1), -1)
    np.add.at(diff, (y1, x0), -1)
    np.add.at(diff, (y1, x1), 1)
    met = int((diff.cumsum(0).cumsum(1) > 0).sum())
    cells = int(((y1 - y0) * (x1 - x0)).sum())
    item = 4 if r.warp_canvas_fp32 else 2
    ilv = bool(r.warp_interleave)
    per_cell = {(1, False): 30, (2, False): 52, (1, True): 44,
                (2, True): 76}[npl, ilv]
    nbytes = 2 * met * 4 * item + nv * npl * RM * RM * 4 + nv * _SCALARS
    return nbytes, cells * per_cell


def frame_bounds(cfg, geo, V):
    """{kernel: least seconds} of one frame."""
    from .reference.warp import slab_vx
    return {"warp_march": least_s(*march_work(cfg, geo, slab_vx(cfg, V), V)),
            "warp_composite": least_s(*composite_work(cfg, geo))}
