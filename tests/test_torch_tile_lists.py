"""Kernel B's per-tile particle lists, kernel D's per-tile lists of
composite positions, and the launch planners of kernels A-D
(volq_torch/render/kernel.py), on the CPU.

* ``tile_lists_plain`` (the plain version of the lists B's launch builds)
  against a brute-force scan of every tile and particle, on the fused
  inputs of small states carrying c3's, c4's and c5's render flags, and
  on made-up boxes: invalid particles, empty boxes, boxes over the canvas
  edge, one tile that every particle covers, and a list longer than one
  shared-memory load of the kernel's bitmap window.  Every list is in
  ascending (depth) order, exactly.  ``tile_fill`` on the CPU: the plain
  lists in the fill kernel's layout, the first ``capt`` of each kept.
* ``chunk_lists_plain`` (the plain version of D's lists) against a
  brute-force scan: each tile's composite positions, in composite order,
  under a given ``order`` and without one, on made-up origins and on the
  unfused inputs of a small state (one chunk through ``order``, and
  megachunks); ``chunk_fill`` on the CPU in the fill kernel's layout;
  ``_check_words``, which refuses bf16 images whose edge values' aligned
  4-byte words (what kernel D copies) reach outside their storage.
* ``march_plan``, ``images_plan``, ``composite_plan`` and ``chunk_plan``
  for every preset's shapes (c1 under the warp engine at march rect 128,
  c2, c3, c4, c4 per-step lit, c5, and each in fp32): A's and C's plans
  fit the 227 KB of shared memory a block may opt into, in the staged
  arm where a slab stage fits, else the global arm, and C keeps A's
  block width, ring and blocks an SM; B's and D's tile grids cover their
  canvases and their list slots stay within the int32 scratch.
"""
import dataclasses

import pytest
import torch

from volq_torch.engine import loop
from volq_torch.render import kernel as K
from volq_torch.render import warp as tw
from volq_torch.scene import config as TC
from volq_torch.scene.config import (SceneConfig, VolumeConfig,
                                     EmitterConfig, CameraConfig,
                                     RenderConfig)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def brute_lists(box, valid, Hc, Wc):
    """Tile by tile, particle by particle: the box-meets-tile test of the
    old whole-list walk."""
    ntx, nty = -(-Wc // K.TILE_W), -(-Hc // K.TILE_H)
    b, v = box.tolist(), valid.tolist()
    out = []
    for ty in range(nty):
        for tx in range(ntx):
            y0, x0 = ty * K.TILE_H, tx * K.TILE_W
            out.append([k for k in range(len(b)) if v[k]
                        and b[k][0] < y0 + K.TILE_H and b[k][1] > y0
                        and b[k][2] < x0 + K.TILE_W and b[k][3] > x0
                        and b[k][1] > b[k][0] and b[k][3] > b[k][2]])
    return out


def check_lists(box, valid, Hc, Wc):
    offs, lists = K.tile_lists_plain(box, valid, Hc, Wc)
    want = brute_lists(box, valid, Hc, Wc)
    assert offs.dtype == lists.dtype == torch.int32
    assert offs.numel() == len(want) + 1 and int(offs[0]) == 0
    o, got = offs.tolist(), lists.tolist()
    assert o[-1] == len(got) == sum(len(w) for w in want)
    for t, w in enumerate(want):
        seg = got[o[t]:o[t + 1]]
        assert seg == w, t
        assert seg == sorted(seg)
    return want


def _scene(**kw):
    return SceneConfig(
        n_particles=40, init="random", seed=7,
        volume=VolumeConfig(size=16, bank_size=4, octaves=2),
        emitter=EmitterConfig(radius=1.8, size_min=0.4, size_max=0.8,
                              life_min=100.0, life_max=100.0,
                              albedo_var=0.3),
        camera=CameraConfig(eye=(0.3, 0.8, -5.0), look_at=(0.0, 0.2, 0.0),
                            fov_y_deg=50.0),
        render=RenderConfig(width=256, height=96, steps=8, engine="warp",
                            warp_pallas=True, warp_rect=48,
                            density_scale=10.0, **kw))


PRESET_FLAGS = {
    "c3": dict(warp_march_rect=32, warp_slab_vx=8, warp_fp32=False,
               warp_canvas_fp32=False),
    "c4": dict(warp_march_rect=32, warp_slab_vx=8, light_steps=4,
               light_mode="center", warp_pair=1, warp_pack=4,
               warp_fp32=False, warp_canvas_fp32=False),
    "c5": dict(warp_march_rect=32, light_steps=4, light_mode="center",
               warp_pair=1, warp_coarse=1, warp_interleave=1,
               warp_fp32=False, warp_canvas_fp32=False),
}


@pytest.mark.parametrize("preset", sorted(PRESET_FLAGS))
def test_lists_of_preset_states_match_brute_force(preset):
    """The fused inputs of a frame (boxes from warp.placement_boxes,
    invalid particles included): every tile's list is the brute-force
    one, in depth order; the CPU fill returns the plain lists."""
    cfg = _scene(**PRESET_FLAGS[preset])
    state, camera, light = loop.setup(cfg, device="cpu")
    lv = loop.cached_light_volumes(state, light, cfg)
    bank, lbank = tw.bake_slab_banks(state.volumes, lv, cfg)
    _, comp, _ = tw.fused_inputs(state.particles, camera, light, cfg, bank,
                                 0, cfg.render.height, lbank)
    box, valid, cp = comp[2], comp[4], comp[5]
    want = check_lists(box, valid, cp.Hc, cp.Wc)
    assert sum(map(len, want)) > cp.N       # boxes span several tiles
    counts, slots = K.tile_fill(box, valid, cp)
    assert slots.shape == (len(want), K.composite_plan(cp).capt)
    assert counts.tolist() == [len(w) for w in want]
    for t, w in enumerate(want):
        assert slots[t, :len(w)].tolist() == w
    # an invalid particle is on no list
    valid2 = valid.clone()
    valid2[::3] = 0
    want2 = check_lists(box, valid2, cp.Hc, cp.Wc)
    dead = set(range(0, cp.N, 3))
    assert not any(dead & set(w) for w in want2)


def test_invalid_empty_and_edge_boxes():
    g = torch.Generator().manual_seed(3)
    N, Hc, Wc = 300, 70, 300
    y0 = torch.randint(-20, Hc + 10, (N,), generator=g)
    x0 = torch.randint(-80, Wc + 40, (N,), generator=g)
    h = torch.randint(-3, 40, (N,), generator=g)
    w = torch.randint(-3, 150, (N,), generator=g)
    box = torch.stack([y0, y0 + h, x0, x0 + w], 1).to(torch.int32)
    valid = (torch.rand(N, generator=g) > 0.2).to(torch.int32)
    want = check_lists(box.contiguous(), valid, Hc, Wc)
    listed = set().union(*map(set, want))
    empty = ((h <= 0) | (w <= 0)).nonzero().flatten().tolist()
    assert empty and not listed & set(empty)
    # beyond the tile grid (a box past the canvas inside its last tile is
    # listed; the kernel skips its cells outside the canvas)
    Hg, Wg = -(-Hc // K.TILE_H) * K.TILE_H, -(-Wc // K.TILE_W) * K.TILE_W
    off = ((y0 >= Hg) | (x0 >= Wg) | (y0 + h <= 0) | (x0 + w <= 0))
    assert not listed & set(off.nonzero().flatten().tolist())


@pytest.mark.parametrize("N", [64, 70000], ids=["c2-like", "two-windows"])
def test_one_tile_every_particle_covers(N):
    """Every particle's box covers tile (1, 1) (as c2's 64 particles at
    rect 272 nearly do); N = 70000 gives a list longer than one bitmap
    window of the kernel's list order (65536 indices): still ascending."""
    g = torch.Generator().manual_seed(N)
    Hc, Wc = 64, 256
    y0 = torch.randint(0, 17, (N,), generator=g)
    x0 = torch.randint(0, 65, (N,), generator=g)
    box = torch.stack([y0, torch.full_like(y0, 32), x0,
                       torch.full_like(x0, 128)], 1).to(torch.int32)
    valid = torch.ones(N, dtype=torch.int32)
    offs, lists = K.tile_lists_plain(box.contiguous(), valid, Hc, Wc)
    ntx = -(-Wc // K.TILE_W)
    t = 1 * ntx + 1
    seg = lists[int(offs[t]):int(offs[t + 1])]
    assert torch.equal(seg, torch.arange(N, dtype=torch.int32))
    if N < 1000:
        check_lists(box.contiguous(), valid, Hc, Wc)


@pytest.mark.parametrize("capt", [0, 1, 5, 300])
def test_fill_keeps_the_first_capt_slots(capt):
    """Lists longer than the plan's slots: every tile still counts its
    whole list (B then tests every particle there), and keeps capt of
    it in its slots."""
    g = torch.Generator().manual_seed(capt)
    N, Hc, Wc = 400, 64, 256
    y0 = torch.randint(-8, Hc, (N,), generator=g)
    x0 = torch.randint(-32, Wc, (N,), generator=g)
    box = torch.stack([y0, y0 + 24, x0, x0 + 90], 1).to(torch.int32)
    valid = (torch.rand(N, generator=g) > 0.1).to(torch.int32)
    cp = K.composite_params(N, 32, Hc, Wc, 0.5)
    plan = K.CompositePlan(ntx=-(-Wc // K.TILE_W), nty=-(-Hc // K.TILE_H),
                           capt=capt)
    counts, slots = K.tile_fill(box.contiguous(), valid, cp, plan)
    want = brute_lists(box, valid, Hc, Wc)
    assert counts.tolist() == [len(w) for w in want]
    assert slots.shape == (len(want), capt)
    assert any(len(w) > capt for w in want) == (capt < 300)
    for t, w in enumerate(want):
        assert slots[t, :min(len(w), capt)].tolist() == w[:capt]


def _with(cfg, **kw):
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, **kw))


PRESETS = {
    "c1_warp": lambda: _with(TC.c1(), engine="warp", warp_pallas=True),
    "c2": TC.c2, "c3": TC.c3, "c4": TC.c4,
    "c4_perstep": lambda: _with(TC.c4(), light_mode="march"),
    "c5": TC.c5,
}


def preset_params(cfg):
    """Kernel A's and B's parameters for a preset's full-size frame,
    from its config alone (as warp.fused_inputs forms them)."""
    r = cfg.render
    V = cfg.volume.size
    lit = (K.UNLIT if not r.light_steps else
           K.CENTER if r.light_mode == "center" else K.PERSTEP)
    mp = K.march_params(cfg.n_particles, r.steps, tw.slab_vx_eff(cfg, V),
                        V, tw.march_rect(cfg), r.warp_rect,
                        r.warp_shift_max, False, r.width, r.height, lit=lit,
                        ortho=cfg.camera.projection == "ortho")
    cg = K.canvas_geom(cfg, r.height)
    RM, RP = mp.RM, r.warp_rect
    gscale = K.cell_to_march(cg, RM, RP) if cg.cells else K._ratio_m(RM, RP)
    cp = K.composite_params(cfg.n_particles, RM, cg.Hc, cg.Wx, gscale,
                            lit=bool(lit), ilv=cg.ilv)
    return mp, cp, 4 if r.warp_fp32 else 2


@pytest.mark.parametrize("fp32", [False, True], ids=["native", "fp32"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_launch_plans_fit_every_preset(preset, fp32):
    cfg = PRESETS[preset]()
    if fp32:
        cfg = _with(cfg, warp_fp32=True, warp_canvas_fp32=True)
    mp, cp, itemsize = preset_params(cfg)
    plan = K.march_plan(mp, itemsize)
    threads = mp.RM * plan.G
    assert threads <= K.MARCH_BLOCK
    assert -(-mp.RM // plan.G) <= K.MARCH_CAP
    assert plan.smem == K.march_smem(mp, plan.stages, itemsize)
    assert plan.smem <= K.SMEM_OPTIN
    slab = mp.VX * mp.V * itemsize
    stage = slab * (2 if mp.lit == K.PERSTEP else 1)
    # every preset's slab stage fits a ring of at least two
    assert plan.stages >= 2 and plan.arm.startswith("staged")
    assert plan.smem >= plan.stages * stage
    # as many stages as leave the SM the blocks its registers allow
    blocks = max(1, 65536 // (threads * 64))
    room = K.SMEM_SM // blocks - 1024
    more = K.march_smem(mp, plan.stages + 1, itemsize)
    assert plan.stages == min(K.MAX_STAGES, mp.S) or more > room
    assert plan.smem <= room or plan.stages == 2
    g_min = -(-mp.RM // K.MARCH_CAP)
    assert plan.G == (g_min if mp.N >= K.N_SM
                      else (g_min + K.MARCH_BLOCK // mp.RM) // 2)
    check_composite_plan(cp)
    # kernel C: A's block width and ring, a band of y-pass rows (none at
    # RM == RP) whose buffers keep C's shared bytes within the SM share of
    # A's blocks (or A's own)
    cplan = K.images_plan(mp, itemsize)
    assert (cplan.G, cplan.stages) == (plan.G, plan.stages)
    assert cplan.smem == K.images_smem(mp, cplan.stages, itemsize,
                                       cplan.band)
    assert plan.smem <= cplan.smem <= K.SMEM_OPTIN
    assert cplan.smem <= max(room, plan.smem)
    if mp.RM == mp.RP:
        assert cplan.band == 0
    else:
        assert 1 <= cplan.band <= mp.RP
        more = K.images_smem(mp, cplan.stages, itemsize, cplan.band + 1)
        assert cplan.band == mp.RP or more > max(room, plan.smem) \
            or -(-mp.RP // (cplan.band + 1)) == -(-mp.RP // cplan.band)
    # kernel D: the unfused canvas and one megachunk
    _, _, Hc, Wc = K._canvas_dims(cfg, cfg.render.height)
    n = tw.mega_chunk(cfg, cfg.n_particles)
    check_chunk_plan(K.ChunkParams(n=n, RP=mp.RP, Hc=Hc, Wc=Wc))


def check_chunk_plan(p):
    dplan = K.chunk_plan(p)
    assert dplan.ntx * K.TILE_W >= p.Wc > (dplan.ntx - 1) * K.TILE_W
    assert dplan.nty * K.TILE_H >= p.Hc > (dplan.nty - 1) * K.TILE_H
    assert min(p.n, 256) <= dplan.capt <= p.n
    assert 2 * dplan.ntx * dplan.nty * dplan.capt < 2 ** 31
    # 8x the average list of rects that each meet the most tiles an RP x
    # RP rect can
    per = (-(-(p.RP - 1) // K.TILE_H) + 1) * (-(-(p.RP - 1) // K.TILE_W) + 1)
    nt = dplan.ntx * dplan.nty
    assert dplan.capt == min(p.n, max(256, -(-8 * p.n * per // nt)))
    return dplan


def check_composite_plan(cp):
    bplan = K.composite_plan(cp)
    assert bplan.ntx * K.TILE_W >= cp.Wc > (bplan.ntx - 1) * K.TILE_W
    assert bplan.nty * K.TILE_H >= cp.Hc > (bplan.nty - 1) * K.TILE_H
    assert min(cp.N, 256) <= bplan.capt <= cp.N
    assert 2 * bplan.ntx * bplan.nty * bplan.capt < 2 ** 31
    return bplan


@pytest.mark.parametrize("N", [1, 64, 16384, 2_000_000])
def test_composite_plan_list_slots(N):
    """B's list slots on c5's canvas and march rect: at least 256 (at
    most N) a tile, more where the boxes crowd the tiles; particles
    enough to overflow the int32 scratch raise."""
    cp = K.composite_params(N, 80, 1088, 1920, K._ratio_m(80, 272))
    if N > 1_000_000:
        with pytest.raises(ValueError):
            K.composite_plan(cp)
        return
    plan = check_composite_plan(cp)
    nt = plan.ntx * plan.nty
    # every box meets at most 19 x 6 tiles at this rect
    assert plan.capt == min(N, max(256, -(-8 * N * 19 * 6 // nt)))


def test_march_plan_arms():
    """The global arm where no ring of two fits (per-step lit, fp32, a
    128 x 128 slab: 128 KB a stage) or a slab is no whole number of
    16-byte copies, or the banks are not 16-byte aligned; RM above 128
    raises."""
    big = K.march_params(4096, 20, 128, 128, 64, 96, 6, True, 1920, 1080,
                         lit=K.PERSTEP)
    assert K.march_plan(big, 4).arm == "global"
    assert K.march_plan(big, 2).arm == "staged x2"
    odd = K.march_params(4096, 20, 7, 18, 64, 96, 6, True, 1920, 1080)
    assert K.march_plan(odd, 2).arm == "global"
    ok = K.march_params(4096, 20, 8, 18, 64, 96, 6, True, 1920, 1080)
    assert K.march_plan(ok, 2).arm == "staged x4"
    assert K.march_plan(ok, 2, aligned=False).arm == "global"
    short = K.march_params(4096, 3, 8, 18, 64, 96, 6, True, 1920, 1080)
    assert K.march_plan(short, 2).stages == 3
    with pytest.raises(ValueError):
        K.march_plan(K.march_params(8, 4, 8, 8, 144, 144, 6, True, 64, 64),
                     4)


# --------------------------------------------------------------------------
# kernel D's lists: composite positions, ascending

def brute_chunk_lists(oy, ox, order, RP, Hc, Wc):
    """Tile by tile, composite position by position: the rect of image
    order[q] (or q) against the tile."""
    ntx, nty = -(-Wc // K.TILE_W), -(-Hc // K.TILE_H)
    y0s, x0s = oy.tolist(), ox.tolist()
    ks = list(range(len(y0s))) if order is None else order.tolist()
    out = []
    for ty in range(nty):
        for tx in range(ntx):
            ty0, tx0 = ty * K.TILE_H, tx * K.TILE_W
            out.append([q for q, k in enumerate(ks)
                        if y0s[k] < ty0 + K.TILE_H and y0s[k] + RP > ty0
                        and x0s[k] < tx0 + K.TILE_W and x0s[k] + RP > tx0])
    return out


def check_chunk_lists(oy, ox, order, p):
    offs, lists = K.chunk_lists_plain(oy, ox, order, p)
    want = brute_chunk_lists(oy, ox, order, p.RP, p.Hc, p.Wc)
    o, got = offs.tolist(), lists.tolist()
    assert offs.dtype == lists.dtype == torch.int32
    assert len(o) == len(want) + 1 and o[-1] == len(got)
    for t, w in enumerate(want):
        assert got[o[t]:o[t + 1]] == w, t
    counts, slots = K.chunk_fill(oy, ox, order, p)
    plan = K.chunk_plan(p)
    assert counts.tolist() == [len(w) for w in want]
    assert slots.shape == (len(want), plan.capt)
    for t, w in enumerate(want):
        assert slots[t, :min(len(w), plan.capt)].tolist() == w[:plan.capt]
    return want


@pytest.mark.parametrize("ordered", [True, False], ids=["order", "stored"])
@pytest.mark.parametrize("RP", [12, 48, 100])
def test_chunk_lists_match_brute_force(RP, ordered):
    """Made-up origins inside the canvas (as the caller clips them), under
    a random composite order and as stored: each tile's list is its
    composite positions, ascending."""
    g = torch.Generator().manual_seed(RP)
    n, Hc, Wc = 300, 150, 400
    oy = torch.randint(0, Hc - RP + 1, (n,), generator=g).to(torch.int32)
    ox = torch.randint(0, Wc - RP + 1, (n,), generator=g).to(torch.int32)
    order = torch.randperm(n, generator=g).to(torch.int32) if ordered \
        else None
    p = K.ChunkParams(n=n, RP=RP, Hc=Hc, Wc=Wc)
    want = check_chunk_lists(oy, ox, order, p)
    assert sum(map(len, want)) > n          # rects span several tiles
    if ordered:   # the positions, not the image indices, are listed
        stored = brute_chunk_lists(oy, ox, None, RP, Hc, Wc)
        assert want != stored


@pytest.mark.parametrize("mega", [0, 8], ids=["one-chunk", "mega8"])
def test_chunk_lists_of_unfused_inputs(mega):
    """The unfused inputs of a frame: one chunk composited through
    ``order`` (every particle, marched as stored), and depth-ordered
    megachunks of 8 (no order)."""
    cfg = _scene(**PRESET_FLAGS["c4"], warp_fused=False, warp_mega=mega)
    state, camera, light = loop.setup(cfg, device="cpu")
    lv = loop.cached_light_volumes(state, light, cfg)
    bank, lbank = tw.bake_slab_banks(state.volumes, lv, cfg)
    chunks, _ = tw.unfused_inputs(state.particles, camera, light, cfg, bank,
                                  0, cfg.render.height, lbank)
    assert len(chunks) == (1 if not mega else cfg.n_particles // 8)
    for _, (oy, ox, order, p) in chunks:
        assert (order is None) == bool(mega)
        check_chunk_lists(oy, ox, order, p)


def test_chunk_fill_keeps_the_first_capt_slots():
    """A chunk whose every rect covers one tile, past the plan's slots:
    the tile counts its whole list and keeps capt of it."""
    n, RP, Hc, Wc = 400, 40, 64, 256
    g = torch.Generator().manual_seed(1)
    oy = torch.randint(0, 17, (n,), generator=g).to(torch.int32)
    ox = torch.randint(25, 65, (n,), generator=g).to(torch.int32)
    order = torch.randperm(n, generator=g).to(torch.int32)
    p = K.ChunkParams(n=n, RP=RP, Hc=Hc, Wc=Wc)
    plan = K.CompositePlan(ntx=4, nty=4, capt=5)
    counts, slots = K.chunk_fill(oy, ox, order, p, plan)
    t = 1 * plan.ntx + 1
    assert int(counts[t]) == n
    assert slots[t].tolist() == list(range(5))


@pytest.mark.parametrize("n", [1, 64, 2048, 10_000_000])
def test_chunk_plan_list_slots(n):
    """D's list slots on c4's unfused canvas: 8x the average list, at
    least 256 (at most n); chunks enough to overflow the int32 scratch
    raise."""
    p = K.ChunkParams(n=n, RP=96, Hc=1280, Wc=2272)
    if n > 1_000_000:
        with pytest.raises(ValueError):
            K.chunk_plan(p)
        return
    check_chunk_plan(p)



@pytest.mark.parametrize("offset,count,start,stop,ok", [
    (0, 36, 0, None, True), (0, 36, 1, -1, True), (0, 33, 0, -1, True),
    (0, 33, 0, None, False), (0, 33, 1, None, False), (2, 33, 1, None, True),
    (2, 33, 0, -1, False)],
    ids=["whole", "inner", "to-even", "to-odd-end", "from-1-odd-end",
         "start-2mod4-from-1", "start-2mod4"])
def test_chunk_word_check(offset, count, start, stop, ok):
    """bf16 images as views of a storage of ``count`` values that starts
    ``offset`` bytes into a 4-byte-aligned buffer: a view whose first or
    last value's aligned 4-byte word reaches outside the storage raises;
    fp32 views never do."""
    for dt in (torch.bfloat16, torch.float32):
        buf = torch.frombuffer(bytearray(offset + 4 * count), dtype=dt,
                               offset=offset, count=count)
        assert buf.untyped_storage().nbytes() == count * buf.element_size()
        view = buf[start:count if stop is None else stop]
        if ok or dt == torch.float32:
            K._check_words(view)
        else:
            with pytest.raises(ValueError):
                K._check_words(view)
