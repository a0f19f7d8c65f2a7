"""Screen-space tile binning (counterpart of ``volq/render/binning.py``).

Project each alive particle's AABB to a conservative screen rectangle,
enumerate the tiles it overlaps as (tile, particle) pairs, and
depth-order the pairs per tile with one stable key sort
(tile_id * 2^rank_bits + depth_rank).

The marched pair list is compacted to ``max_pairs`` entries, so march cost
follows screen coverage, not a padded per-tile cap.  Every capacity cap is
counted in the returned stats, never silent:
  * mt_overflow  -- tiles lost because a particle spans more than
                    max_tiles_per_particle
  * cap_dropped  -- valid pairs beyond the max_pairs budget
  * rank_dropped -- kept pairs beyond max_pairs_per_tile composite depth
"""
from __future__ import annotations

from typing import NamedTuple, Any

import torch

from volq_torch.core.camera import view_z
from volq_torch.core.device import scalar
from volq_torch.core.types import Camera, Particles
from volq_torch.scene.config import SceneConfig

_NEAR_EPS = 1e-3
_INVALID_KEY = 2**31 - 1


class PairList(NamedTuple):
    pid: Any        # [P] i32 particle index per kept pair
    tile: Any       # [P] i32 LOCAL tile id per kept pair (sorted ascending)
    valid: Any      # [P] bool
    seg_start: Any  # [T] i32 first pair index of each tile's segment
    count: Any      # [T] i32 number of kept pairs per tile
    sort_idx: Any   # [P] i32 flat (particle * MT + slot) of each kept pair
    cand_tile: Any  # [N, MT] i32 LOCAL tile per candidate slot
    cand_valid: Any # [N, MT] bool candidate validity
    stats: Any      # dict of 0-d integer tensors


def _corners(pos, size):
    """[N, 8, 3] world corners of each particle's cubic AABB."""
    signs = torch.tensor(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        dtype=torch.float32, device=pos.device)
    return pos[:, None, :] + size[:, None, None] * signs[None]


def _screen_rect(particles: Particles, camera: Camera, cfg: SceneConfig):
    """Conservative pixel-space rect per particle + validity mask."""
    r = cfg.render
    W, H = r.width, r.height
    c = _corners(particles.pos, particles.size)          # [N,8,3]
    rel = c - camera.eye

    def along(axis):
        return (rel[..., 0] * axis[0] + rel[..., 1] * axis[1]
                + rel[..., 2] * axis[2])

    vx, vy, vz = along(camera.right), along(camera.up), along(camera.fwd)

    if cfg.camera.projection == "persp":
        near = vz.amin(dim=1) < _NEAR_EPS            # straddles near plane
        vz_safe = torch.clamp(vz, min=_NEAR_EPS)
        ndc_x = vx / (vz_safe * camera.scale_x)
        ndc_y = vy / (vz_safe * camera.scale_y)
        in_front = vz.amax(dim=1) > _NEAR_EPS
    else:
        near = torch.zeros(c.shape[0], dtype=torch.bool, device=c.device)
        ndc_x = vx / camera.scale_x
        ndc_y = vy / camera.scale_y
        in_front = vz.amax(dim=1) > 0.0              # some of the box ahead

    px = (ndc_x + 1.0) * 0.5 * W
    py = (1.0 - ndc_y) * 0.5 * H
    zero = torch.zeros((), dtype=torch.float32, device=c.device)
    x_min = torch.where(near, zero, px.amin(dim=1))
    x_max = torch.where(near, zero + float(W), px.amax(dim=1))
    y_min = torch.where(near, zero, py.amin(dim=1))
    y_max = torch.where(near, zero + float(H), py.amax(dim=1))

    alive = particles.age < particles.lifetime
    on_screen = (x_max >= 0) & (x_min <= W) & (y_max >= 0) & (y_min <= H)
    valid = alive & in_front & on_screen
    if r.near_fade_start > 0.0:
        # camera-proximity fade: fully transparent particles render
        # nothing -- cull them before they explode the tile-span caps
        valid = valid & (view_z(camera, particles.pos) > r.near_fade_end)
    return (x_min, x_max, y_min, y_max), valid


def bin_particles(particles: Particles, camera: Camera, cfg: SceneConfig,
                  tile_start=0, n_tiles_local: int | None = None) -> PairList:
    """Bin into the (global) flat-tile range
    [tile_start, tile_start + n_tiles_local).  ``tile_start`` may be a
    tensor; ``n_tiles_local`` is a Python int.  PairList.tile holds LOCAL
    tile ids.  The defaults cover the whole screen."""
    r = cfg.render
    tiles_x = r.width // r.tile_w
    tiles_y = r.height // r.tile_h
    if n_tiles_local is None:
        n_tiles_local = tiles_x * tiles_y
    n_tiles = n_tiles_local
    N = particles.age.shape[0]
    MT = r.max_tiles_per_particle
    P = r.max_pairs
    dev = particles.age.device
    i32 = dict(dtype=torch.int32, device=dev)
    tile_start = torch.as_tensor(tile_start, **i32)

    (x_min, x_max, y_min, y_max), valid = _screen_rect(particles, camera, cfg)

    def tile_of(x, size, n):
        return torch.clamp(torch.floor(x / scalar(size, x)), 0,
                           n - 1).to(torch.int32)

    tx0 = tile_of(x_min, r.tile_w, tiles_x)
    tx1 = tile_of(x_max, r.tile_w, tiles_x)
    ty0 = tile_of(y_min, r.tile_h, tiles_y)
    ty1 = tile_of(y_max, r.tile_h, tiles_y)
    w_t = tx1 - tx0 + 1
    h_t = ty1 - ty0 + 1
    span = w_t * h_t
    mt_overflow = torch.sum(torch.where(valid, torch.clamp(span - MT, min=0),
                                        torch.zeros_like(span)))

    # depth rank: stable position in ascending view-z order among valid
    z = view_z(camera, particles.pos)
    z = torch.where(valid, z, torch.full_like(z, float("inf")))
    order = torch.argsort(z, stable=True)
    rank = torch.zeros((N,), **i32)
    rank[order] = torch.arange(N, **i32)

    rank_bits = max(int(N - 1).bit_length(), 1)
    assert n_tiles < (2**31) >> rank_bits, "tile/rank key overflows int32"

    # candidate pairs [N, MT], row-major over the particle's tile rect,
    # kept only if they land in this local tile range
    rr = torch.arange(MT, **i32)[None, :]
    dx = rr % w_t[:, None]
    dy = torch.div(rr, w_t[:, None], rounding_mode="floor")
    cand_tile = (ty0[:, None] + dy) * tiles_x + (tx0[:, None] + dx)
    local_tile = cand_tile - tile_start
    cand_valid = (valid[:, None] & (rr < span[:, None])
                  & (local_tile >= 0) & (local_tile < n_tiles))
    key = torch.where(cand_valid, (local_tile << rank_bits) | rank[:, None],
                      torch.full_like(local_tile, _INVALID_KEY))

    flat_key = key.reshape(-1)
    sort_idx = torch.argsort(flat_key, stable=True)[:P]
    kept_key = flat_key[sort_idx]
    kept_valid = kept_key != _INVALID_KEY
    pair_pid = torch.div(sort_idx, MT, rounding_mode="floor").to(torch.int32)
    pair_tile = torch.where(kept_valid, kept_key >> rank_bits,
                            torch.full_like(kept_key, n_tiles))

    # per-tile segments within the kept, tile-sorted pair list
    tids = torch.arange(n_tiles, **i32)
    seg_start = torch.searchsorted(pair_tile, tids, right=False) \
        .to(torch.int32)
    seg_end = torch.searchsorted(pair_tile, tids, right=True).to(torch.int32)
    count = seg_end - seg_start

    n_valid = torch.sum(cand_valid)
    n_kept = torch.sum(kept_valid)
    stats = {
        "alive": torch.sum(particles.age < particles.lifetime),
        "pairs_valid": n_valid,
        "pairs_kept": n_kept,
        "mt_overflow": mt_overflow,
        "cap_dropped": n_valid - n_kept,
        "rank_dropped": torch.sum(
            torch.clamp(count - r.max_pairs_per_tile, min=0)),
        "max_pairs_per_tile_seen": count.max(),
    }
    return PairList(pid=pair_pid, tile=pair_tile, valid=kept_valid,
                    seg_start=seg_start, count=count,
                    sort_idx=sort_idx.to(torch.int32),
                    cand_tile=torch.where(cand_valid, local_tile,
                                          torch.zeros_like(local_tile)),
                    cand_valid=cand_valid, stats=stats)
