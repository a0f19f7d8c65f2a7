"""The sharded frame (counterpart of ``volq/dist/sharded.py``): one frame
step on every rank of a mesh, in lockstep.

  * sim: particle slots sharded over the ranks (``shard_state``);
    emission ranks are made global with a prefix over ranks
    (``sim_step(group=)``), and the per-slot PRNG keeps every attribute
    equal to the single-device step's;
  * animated re-bake: bank entries split over the ranks when the bank
    size divides by the mesh size, then all-gathered; otherwise every
    rank bakes the whole bank;
  * the stepped particles are all-gathered: every rank renders from the
    whole particle state;
  * exact and slab engines: each rank renders a contiguous flat-tile
    range (``render_frame_tiles``), and rank 0 gathers the tiles;
  * warp engine: each rank marches and composites a contiguous slice of
    the depth order onto a full-frame canvas (``render_warp_canvas``, on
    the card kernels A and B), crops its padding, and the canvases
    combine by binary swap (``_binary_swap``); rank 0 gathers the rows
    and finishes the frame;
  * stats: summed over ranks, except that the tile engines take the max
    of the three counts every rank computes from the whole state.

The image comes back on rank 0 only (None on the other ranks); the state
each rank returns holds its own particle shard.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from volq_torch.core.camera import view_z
from volq_torch.core.types import Particles, SceneState
from volq_torch.dist.mesh import Mesh
from volq_torch.render import render_frame_tiles, assemble_image
from volq_torch.render import kernel as K
from volq_torch.render.warp import (bake_slab_banks, render_warp_canvas,
                                    _canvas_finish)
from volq_torch.scene.config import SceneConfig
from volq_torch.sim.step import sim_step
from volq_torch.volume.bake import bake_bank_4d
from volq_torch.volume.lightbake import render_light_volumes

# counts every rank of a tile engine computes from the whole particle
# state: the same on every rank, reduced by max
_REPLICATED = ("alive", "mt_overflow", "max_pairs_per_tile_seen")


def _cdiv(a, b):
    return -(-a // b)


def _all_gather_cat(x):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def _gather_cat(x, dim: int = 0):
    """Rank 0: the ranks' ``x`` concatenated along ``dim``; else None."""
    x = x.contiguous()
    if dist.get_rank() == 0:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.gather(x, parts, dst=0)
        return torch.cat(parts, dim=dim)
    dist.gather(x, None, dst=0)
    return None


def _over(front, back):
    """Associative OVER of packed canvases [4, h, w] (C premult, T)."""
    return torch.cat([front[:3] + front[3:4] * back[:3],
                      front[3:4] * back[3:4]])


def _exchange(x, peer: int, bf16_wire: bool, on_send=None):
    """Send ``x`` to rank ``peer`` and receive its tensor of the same
    shape, both in flight at once (no pair of ranks can deadlock).  With
    ``bf16_wire`` the payload travels as bf16 and comes back as
    ``x.dtype``.  ``on_send`` sees every payload handed to the wire."""
    payload = (x.to(torch.bfloat16) if bf16_wire else x).contiguous()
    if on_send is not None:
        on_send(payload)
    buf = torch.empty_like(payload)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, payload, peer),
                                       dist.P2POp(dist.irecv, buf, peer)]):
        req.wait()
    return buf.to(x.dtype)


def _binary_swap(canvas, rank: int, n: int, bf16_wire: bool = False,
                 on_send=None):
    """Binary-swap compositing: every rank enters with the canvas of its
    depth slice ([4, H, W], C premultiplied and T) and leaves with its
    1/n contiguous row range of the composited canvas (rows padded to a
    multiple of n with C = 0, T = 1).  log2(n) rounds: round r pairs the
    ranks that differ in bit r (the lower rank holds the nearer slice,
    the front of the OVER) and each keeps the half of its region named by
    that bit; the closing exchange (bit reversal, an involution) puts the
    row ranges back in rank order.  ``bf16_wire``: every payload travels
    as bf16; the OVER is done in the canvas's fp32."""
    _, Hc, Wc = canvas.shape
    nr = n.bit_length() - 1
    Hp = _cdiv(Hc, n) * n
    if Hp != Hc:
        pad = torch.zeros((4, Hp - Hc, Wc), dtype=canvas.dtype,
                          device=canvas.device)
        pad[3] = 1.0
        canvas = torch.cat([canvas, pad], dim=1)
    region = canvas
    for rnd in range(nr):
        size = region.shape[1] // 2
        first, second = region[:, :size], region[:, size:2 * size]
        am_first = (rank >> rnd) & 1 == 0
        keep, send = (first, second) if am_first else (second, first)
        recv = _exchange(send, rank ^ (1 << rnd), bf16_wire, on_send)
        region = _over(keep, recv) if am_first else _over(recv, keep)
    peer = int(format(rank, f"0{nr}b")[::-1], 2) if nr else rank
    if peer != rank:
        region = _exchange(region, peer, bf16_wire, on_send)
    return region


def shard_state(state: SceneState, mesh: Mesh, rank: int) -> SceneState:
    """Rank ``rank``'s part of a whole state: its contiguous block of
    particle slots; everything else is replicated."""
    n = state.particles.age.shape[0] // mesh.size
    return state._replace(particles=Particles(
        *(f[rank * n:(rank + 1) * n].contiguous()
          for f in state.particles)))


def gather_state(state: SceneState) -> SceneState:
    """The whole state from the ranks' shards (a collective: every rank
    calls it and gets the whole state)."""
    return state._replace(particles=Particles(
        *(_all_gather_cat(f) for f in state.particles)))


def check_mesh(cfg: SceneConfig, n: int) -> None:
    """The preconditions of the sharded frame (ValueError)."""
    r = cfg.render
    warp = r.engine == "warp"
    if cfg.n_particles % n:
        raise ValueError(f"n_particles {cfg.n_particles} must divide by "
                         f"mesh size {n}")
    if warp and (n & (n - 1)):
        raise ValueError(f"warp engine: mesh size {n} must be a "
                         "power of two (binary-swap compositing)")
    if warp and not r.warp_canvas_fp32:
        raise ValueError("warp engine: the sharded binary-swap combine "
                         "requires warp_canvas_fp32=True")


def sharded_frame_fn(cfg: SceneConfig, mesh: Mesh,
                     n_frames_per_call: int = 1, on_send=None):
    """The frame step of this rank of ``mesh`` (call it after
    ``mesh.join``): f(state, camera, light) -> (state', image [H, W, 4]
    on rank 0 and None elsewhere, stats), ``state`` this rank's shard
    (``shard_state``).  ``n_frames_per_call`` advances that many frames
    per call and returns the last frame's image and stats.
    ``on_send(payload)`` sees every tensor the warp engine's binary swap
    hands to the wire.  Raises ValueError when the mesh does not fit
    ``cfg`` (``check_mesh``)."""
    n = mesh.size
    check_mesh(cfg, n)
    r, v = cfg.render, cfg.volume
    warp = r.engine == "warp"
    n_tiles = (r.width // r.tile_w) * (r.height // r.tile_h)
    tiles_local = _cdiv(n_tiles, n)
    bake_sharded = v.animated and v.bank_size % n == 0
    cache = {}

    def bake(state, ids=None):
        return bake_bank_4d(
            v.bank_size, v.size, v.seed, state.time, octaves=v.octaves,
            noise_scale=v.noise_scale, time_scale=v.time_scale,
            cutoff=v.cutoff, edge=v.edge, device=state.volumes.device,
            ids=ids)

    def body(state, camera, light, rank):
        state = sim_step(state, cfg, group=dist.group.WORLD)
        if v.animated:
            if bake_sharded:
                m = v.bank_size // n
                volumes = _all_gather_cat(bake(state, torch.arange(
                    rank * m, (rank + 1) * m)))
            else:
                volumes = bake(state)
            state = state._replace(volumes=volumes)
        parts = Particles(*(_all_gather_cat(f) for f in state.particles))

        # the light and slab banks, as the unsharded loop bakes them: once
        # for a static scene, every frame (inside the render for the slab
        # banks) for an animated one
        if "lv" in cache:
            lv, sb = cache["lv"], cache["sb"]
        else:
            lv = render_light_volumes(state.volumes, light, cfg)
            sb = bake_slab_banks(state.volumes, lv, cfg) \
                if warp and not v.animated else None
            if not v.animated:
                cache.update(lv=lv, sb=sb)

        if warp:
            z = torch.where(parts.age < parts.lifetime,
                            view_z(camera, parts.pos),
                            torch.full_like(parts.age, float("inf")))
            order = torch.argsort(z, stable=True)
            n_p = cfg.n_particles // n
            ids = order[rank * n_p:(rank + 1) * n_p]
            canvas, stats = render_warp_canvas(
                Particles(*(f[ids] for f in parts)), state.volumes, camera,
                light, cfg, light_volumes=lv, slab_banks=sb)
            # OVER is per pixel: crop the padding before the swap
            g = K.canvas_geom(cfg, r.height)
            canvas = canvas[:, g.pad:g.pad + g.hc_img, g.pad:g.pad + g.wc_img]
            tiles = _binary_swap(canvas, rank, n,
                                 bf16_wire=bool(r.warp_swap_bf16),
                                 on_send=on_send)
        else:
            tiles, stats = render_frame_tiles(
                parts, state.volumes, camera, light, cfg,
                tile_start=rank * tiles_local, n_tiles_local=tiles_local,
                light_volumes=lv)
        return state, tiles, stats

    def reduce_stats(stats):
        keys = sorted(stats)
        vals = torch.stack([stats[k].to(torch.int64).reshape(())
                            for k in keys])
        out = vals.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        if not warp:
            dist.all_reduce(vals, op=dist.ReduceOp.MAX)
            rep = torch.tensor([k in _REPLICATED for k in keys],
                               device=vals.device)
            out = torch.where(rep, vals, out)
        return {k: out[i].to(stats[k].dtype) for i, k in enumerate(keys)}

    def finish(tiles):
        if warp:
            X = _gather_cat(tiles, dim=1)
            return None if X is None else _canvas_finish(
                X[:3], X[3], cfg, r.height, cropped=True)
        flat = _gather_cat(tiles)
        return None if flat is None else assemble_image(flat, cfg)

    def frame(state, camera, light):
        rank = dist.get_rank()
        for _ in range(n_frames_per_call):
            state, tiles, stats = body(state, camera, light, rank)
        return state, finish(tiles), reduce_stats(stats)

    return frame
