"""Scene configuration (SURVEY.md C11 + section 5 "config/flag system").

The PyTorch port's own copy of ``volq/scene/config.py``: the same
dataclasses, validation, JSON round-trip and presets, kept verbatim so
a config serializes identically in both packages (importing
``volq.scene`` would pull in JAX).  The flag comments describe the JAX
package's TPU engine; which flags the port renders is checked in
``volq_torch/render/warp.py``.

The reference exposed its tunables as Unity inspector fields serialized in
the scene asset; here they are frozen dataclasses (hashable => usable as
static jit arguments), serializable to/from JSON, with the five BASELINE
configs (BASELINE.json:7-11) shipped as named presets c1..c5.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Tuple

Vec3 = Tuple[float, float, float]


@dataclass(frozen=True)
class VolumeConfig:
    size: int = 32            # V: voxels per axis
    bank_size: int = 1        # M: number of distinct volumes in the bank
    octaves: int = 4
    noise_scale: float = 4.0
    cutoff: float = 0.3   # noise threshold at the center
    edge: float = 0.9     # radius^2 coefficient carving the boundary
    animated: bool = False    # 4D time-animated noise, re-baked per frame
    time_scale: float = 0.5
    seed: int = 7


@dataclass(frozen=True)
class EmitterConfig:
    rate: float = 0.0         # spawns/second (0 => static scene)
    center: Vec3 = (0.0, 0.0, 0.0)
    radius: float = 1.0       # spawn positions uniform in this ball
    vel_base: Vec3 = (0.0, 0.0, 0.0)
    vel_spread: float = 0.0   # isotropic normal std added to vel_base
    life_min: float = 2.0
    life_max: float = 4.0
    size_min: float = 0.5     # AABB half-extent range
    size_max: float = 0.5
    albedo_base: Vec3 = (1.0, 1.0, 1.0)
    albedo_var: float = 0.0   # per-channel multiplicative variation in [0,1]


@dataclass(frozen=True)
class ForcesConfig:
    gravity: Vec3 = (0.0, 0.0, 0.0)
    drag: float = 0.0
    curl_strength: float = 0.0
    curl_freq: float = 0.25
    curl_seed: int = 77


@dataclass(frozen=True)
class CameraConfig:
    eye: Vec3 = (0.0, 0.0, -8.0)
    look_at: Vec3 = (0.0, 0.0, 0.0)
    up: Vec3 = (0.0, 1.0, 0.0)
    projection: str = "persp"   # "persp" | "ortho"
    fov_y_deg: float = 45.0
    ortho_half_h: float = 2.0


@dataclass(frozen=True)
class LightConfig:
    direction: Vec3 = (0.4, 1.0, -0.4)  # toward the light (normalized later)
    color: Vec3 = (1.0, 0.96, 0.9)
    ambient: Vec3 = (0.08, 0.09, 0.12)


@dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    engine: str = "exact"      # "exact" (per-ray gather march, the
                               # semantics-of-record path) | "slab"
                               # (gather-free z-plane/MXU path, render/slab.py)
                               # | "warp" (per-particle shear-warp impostor
                               # path, render/warp.py — the fast path)
    steps: int = 32            # primary march steps per (ray, particle)
    light_steps: int = 0       # secondary light-march steps (0 => unshadowed)
    slab_fp32: bool = True     # slab engine: fp32 weights/slabs (False:
                               # bf16 — faster, needs the bf16 oracle mode)
    slab_pair_chunk: int = 2048  # slab engine: pairs marched per lax.map
                               # chunk (bounds the [chunk, tp, V] weight
                               # workspace; 0 => no chunking)
    slab_window: int = 0       # slab engine: in-plane window width in
                               # voxels (0 => full V). Part of the sampling
                               # spec: coords clamp into the per-(tile,
                               # particle) corner-ray rectangle.
    slab_grouped: bool = False # slab engine: march the [N, MT] candidate
                               # grid per particle so each step's slab is
                               # fetched once per particle (needed for
                               # per-particle volume banks)
    slab_particle_chunk: int = 64  # particles per lax.map chunk (grouped)
    density_scale: float = 8.0 # extinction scale applied to sampled density
    fade_in: float = 0.15      # opacity envelope, fractions of lifetime
    fade_out: float = 0.3
    near_fade_start: float = 0.0  # camera-proximity fade: full opacity
                               # beyond this view depth; 0 disables
    near_fade_end: float = 0.0    # fully transparent at/inside this depth
                               # (culled from binning)
    warp_rect: int = 128       # warp engine: per-particle image rect in
                               # pixels (RP x RP); particles with a larger
                               # screen footprint are clipped (counted in
                               # stats as rect_overflow)
    light_mode: str = "march"  # baked-light sampling in the slab/warp
                               # fast paths: "march" samples the light
                               # volume at EVERY step (per-sample
                               # attenuation, like the exact engine);
                               # "center" samples it ONCE per ray at the
                               # particle's mid-depth (warp engine only:
                               # per-ray shadow gradients, telescoped
                               # march, ~2x lit-march cost cut)
    warp_march_rect: int = 0   # warp engine: march-grid resolution RM
                               # (RM x RM rays per particle, upsampled to
                               # warp_rect in the epilogue).  0 / >= RP
                               # marches at full rect resolution.  Set
                               # ~V (the voxels spanned by the footprint)
                               # to stop paying screen-res march cost for
                               # volume-res detail.  Multiple of 16;
                               # single-rect-class only.
    warp_slab_vx: int = 0      # warp engine + pallas: x-resample the
                               # pre-lerped slab banks to this many
                               # sublane points (align-corners fp32
                               # lerp, render/warp.bake_march_slabs).
                               # Cuts slab DMA + march dot FLOPs + WxT
                               # build by vx/V.  0 / >= V disables; only
                               # applies when slab banks are in use and
                               # the march telescopes (unlit or
                               # light_mode="center").  Multiple of 8.
    warp_pair: int = 0         # warp engine + pallas FUSED path: march
                               # TWO depth-consecutive particles per grid
                               # step, packing their dot operands into
                               # full-width MXU tiles ([2RM, 2V] block
                               # weights, [2RM, U*VX] merged contraction)
                               # and halving the fixed per-grid-step
                               # cost.  Bit-identical to the unpaired
                               # path (zero-block packing adds exact
                               # zeros).  Requires slab banks, a
                               # telescoped march (unlit or
                               # light_mode="center"), RM <= 64 and an
                               # even particle count; silently falls
                               # back to unpaired otherwise.  0/1.
    warp_pack: int = 1         # warp engine + pallas FUSED path: pack
                               # this many (pairs of) particles into ONE
                               # Pallas grid entry.  The per-grid-entry
                               # machinery (grid sequencing + per-n
                               # block transitions) measured ~2 us/pair
                               # — the whole c4-class floor
                               # (bench/ladders/r5_floor_sweep.json) —
                               # and packing pays it once per QP pairs.
                               # Bit-identical canvas: the packed pairs
                               # run sequentially in exactly the order
                               # consecutive grid entries used to, same
                               # window-DMA protocol.  Fused slab-bank
                               # single-grid-row marches only; silently
                               # halves until it divides the pair count
                               # (1 = unpacked).  Power of two, 1..8.
    warp_coarse: int = 0       # warp engine + pallas FUSED path:
                               # composite the canvas at MARCH resolution
                               # (cells of (RP-1)/(RM-1) px) instead of
                               # pixels — per-particle window DMA, the
                               # placement matmuls and the RMW all shrink
                               # by ~(RP/RM)^2; one bilinear upsample to
                               # pixels runs per frame in the canvas
                               # finish.  Changes the image (OVER runs at
                               # cell resolution): PSNR-gated like
                               # march-resolution decoupling, mirrored
                               # exactly by the oracle.  Requires
                               # warp_pallas + warp_fused + march-res
                               # decoupling (warp_march_rect < rect). 0/1.
    warp_canvas_scale: float = 0.0  # warp engine + pallas FUSED path:
                               # composite at an ARBITRARY canvas
                               # resolution of this many cells per
                               # pixel (generalizes warp_coarse, whose
                               # cells are march cells = the minimum
                               # useful scale).  E.g. 0.7 shrinks the
                               # canvas, windows, placement and RMW by
                               # ~0.49x while keeping more compositing
                               # resolution than coarse — the quality /
                               # traffic knob between coarse and full
                               # res.  PSNR-gated like coarse; mirrored
                               # by the oracle.  Must be >= the march
                               # ratio (RM-1)/(RP-1) (the canvas cannot
                               # be coarser than the march content).
                               # 0 = off.  Mutually exclusive with
                               # warp_coarse.
    warp_interleave: int = 0   # warp engine + pallas FUSED path: store
                               # the canvas CHANNEL-INTERLEAVED
                               # ([Hc, 4*Wc], lane = 4*x + channel) so a
                               # window's 128-lane alignment slop is paid
                               # once instead of per channel (~2x less
                               # window DMA at c4-class rects).  Pure
                               # layout change — same math, same oracle.
                               # Requires warp_pallas + warp_fused. 0/1.
    warp_canvas_vmem: int = 0  # warp engine + pallas FUSED path: keep
                               # the whole canvas VMEM-RESIDENT inside
                               # the kernel — per-particle window
                               # fetch/write-back become on-chip
                               # VMEM->VMEM copies (no HBM window
                               # traffic, no hazard-stall cost), the
                               # canvas initializes in-kernel and ONE
                               # flush DMA writes it out at the end.
                               # Bit-identical to the windowed path
                               # (storage-only change).  The canvas must
                               # fit ~11 MB of VMEM: shrink it with
                               # warp_coarse and/or warp_bands.  Charges
                               # the slab-bank residency budgets (may
                               # flip a resident bank back to streaming;
                               # pairing then streams per-member stack
                               # blocks).  0/1.
    warp_bands: int = 1        # warp engine: render the frame as this
                               # many horizontal pixel bands, one fused
                               # kernel dispatch each (disjoint pixels:
                               # EXACT — per-band compositing is the
                               # same math).  Shrinks the canvas by
                               # ~1/bands so warp_canvas_vmem fits at
                               # pixel resolution; particles straddling
                               # a band boundary march once per band
                               # touched (~rect/height extra march per
                               # boundary).
    warp_hazard_passes: int = 0  # warp engine + pallas FUSED path,
                               # UNPAIRED: passes of the bit-exact
                               # adjacent-swap reorder that bubbles
                               # disjoint windows between overlapping
                               # depth-neighbors (win_hazard stalls the
                               # double-buffered canvas protocol).  The
                               # paired kernel runs its own pair-aware
                               # pass instead.  0 = off.
    warp_shift_max: int = 8    # warp engine: max fan-correction shift in
                               # grid cells (K); larger shifts clamp
                               # (counted as shift_clamped)
    warp_chunk: int = 64       # warp engine: particles marched per
                               # lax.map chunk
    warp_mega: int = 0         # warp engine: particles per depth-sorted
                               # march+composite megachunk (bounds the
                               # [chunk, 4, RP, RP] image buffer; 0 = all
                               # at once; ignored by the fused path)
    warp_fused: bool = True    # warp engine + pallas: fuse the composite
                               # into the march kernel's epilogue (no
                               # per-particle image round-trip); False
                               # keeps the separate march + composite
                               # kernels (A/B + test path)
    warp_fp32: bool = True     # warp engine: fp32 weights/slabs (False:
                               # bf16 march + bf16-quantized images)
    warp_canvas_fp32: bool = True  # warp engine: fp32 composite canvas
                               # (False: bf16 — halves composite traffic;
                               # single-chip only: the sharded
                               # binary-swap combine requires fp32)
    warp_swap_bf16: int = 0    # warp engine, SHARDED path: ship the
                               # binary-swap ppermute payloads as bf16
                               # (the OVER still accumulates fp32 on
                               # arrival) — halves the per-chip ICI
                               # combine wire (DESIGN 5h#3).  Changes
                               # the image (wire quantization): turns
                               # the sharded==single-chip bit-exactness
                               # into a PSNR-gated property.  0/1.
    warp_pallas: bool = False  # warp engine: use the Pallas TPU kernels
                               # (render/kernel.py) for march + composite
    tile_h: int = 8            # screen tile shape; (8, 128) is VPU-native
    tile_w: int = 128
    max_tiles_per_particle: int = 64   # MT: candidate pairs per particle
    max_pairs: int = 8192              # compact marched-pair budget
    max_pairs_per_tile: int = 32       # per-tile composite depth (K)
    background: Vec3 = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class SceneConfig:
    n_particles: int = 64
    dt: float = 1.0 / 60.0
    seed: int = 0
    init: str = "empty"        # "empty" | "random" | "grid" | "single"
    init_age_frac: Tuple[float, float] = (0.45, 0.55)  # age/lifetime at init
    volume: VolumeConfig = field(default_factory=VolumeConfig)
    emitter: EmitterConfig = field(default_factory=EmitterConfig)
    forces: ForcesConfig = field(default_factory=ForcesConfig)
    camera: CameraConfig = field(default_factory=CameraConfig)
    light: LightConfig = field(default_factory=LightConfig)
    render: RenderConfig = field(default_factory=RenderConfig)

    def __post_init__(self):
        r = self.render
        if r.width % r.tile_w or r.height % r.tile_h:
            raise ValueError(
                f"image {r.width}x{r.height} must tile exactly by "
                f"{r.tile_w}x{r.tile_h}")
        if self.camera.projection not in ("persp", "ortho"):
            raise ValueError(f"bad projection {self.camera.projection!r}")
        if r.engine not in ("exact", "slab", "warp"):
            raise ValueError(f"bad render engine {r.engine!r} "
                             "(expected 'exact', 'slab' or 'warp')")
        if r.light_mode not in ("march", "center"):
            raise ValueError(f"bad light_mode {r.light_mode!r} "
                             "(expected 'march' or 'center')")
        if r.warp_march_rect and r.warp_march_rect % 16:
            raise ValueError("warp_march_rect must be a multiple of 16")
        if r.warp_slab_vx and (r.warp_slab_vx % 8 or r.warp_slab_vx < 8):
            raise ValueError("warp_slab_vx must be a multiple of 8, >= 8")
        if (r.warp_coarse or r.warp_interleave) and not (
                r.warp_pallas and r.warp_fused):
            raise ValueError("warp_coarse / warp_interleave require the "
                             "fused Pallas path (warp_pallas + warp_fused)")
        if r.warp_coarse and not (0 < r.warp_march_rect < r.warp_rect):
            raise ValueError("warp_coarse requires march-resolution "
                             "decoupling (0 < warp_march_rect < warp_rect)")
        if r.warp_canvas_scale:
            if not (r.warp_pallas and r.warp_fused):
                raise ValueError("warp_canvas_scale requires the fused "
                                 "Pallas path (warp_pallas + warp_fused)")
            if r.warp_coarse:
                raise ValueError("warp_canvas_scale and warp_coarse are "
                                 "mutually exclusive (coarse IS scale = "
                                 "the march ratio)")
            rm = r.warp_march_rect or r.warp_rect
            ratio_m = (rm - 1) / max(r.warp_rect - 1, 1)
            if not (ratio_m <= r.warp_canvas_scale <= 1.0):
                raise ValueError(
                    f"warp_canvas_scale must be within [march ratio "
                    f"{ratio_m:.3f}, 1.0] — the canvas cannot be coarser "
                    f"than the march content")
        if r.warp_canvas_vmem and not (r.warp_pallas and r.warp_fused):
            raise ValueError("warp_canvas_vmem requires the fused Pallas "
                             "path (warp_pallas + warp_fused)")
        if r.warp_pack not in (1, 2, 4, 8):
            raise ValueError("warp_pack must be a power of two in 1..8")
        if r.warp_bands < 1:
            raise ValueError("warp_bands must be >= 1")
        if r.warp_bands > 1 and r.engine != "warp":
            raise ValueError("warp_bands > 1 requires engine='warp'")
        if r.warp_bands > r.height:
            raise ValueError("warp_bands must not exceed render height")


# ---------------------------------------------------------------------------
# JSON round-trip (the "config file + flag overrides" story of SURVEY §5).

def _from_dict(cls, d):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) or f.name in (
                "volume", "emitter", "forces", "camera", "light", "render"):
            sub = {"volume": VolumeConfig, "emitter": EmitterConfig,
                   "forces": ForcesConfig, "camera": CameraConfig,
                   "light": LightConfig, "render": RenderConfig}[f.name]
            v = _from_dict(sub, v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def to_json(cfg: SceneConfig) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def from_json(text: str) -> SceneConfig:
    return _from_dict(SceneConfig, json.loads(text))


# ---------------------------------------------------------------------------
# The five BASELINE presets (BASELINE.json:7-11).

def c1() -> SceneConfig:
    """Single static particle, 32^3 volume, 256x256 ortho camera."""
    return SceneConfig(
        n_particles=1, init="single", seed=1,
        volume=VolumeConfig(size=32, bank_size=1, noise_scale=6.0, octaves=5),
        emitter=EmitterConfig(center=(0.0, 0.0, 0.0), size_min=1.0,
                              size_max=1.0, life_min=1e4, life_max=1e4),
        camera=CameraConfig(eye=(0.0, 0.0, -4.0), projection="ortho",
                            ortho_half_h=1.5),
        render=RenderConfig(width=256, height=256, steps=32,
                            max_tiles_per_particle=64, max_pairs=1024,
                            max_pairs_per_tile=4, density_scale=10.0),
    )


def c2() -> SceneConfig:
    """64 particles sharing one 64^3 volume, 512x512 perspective,
    depth-sorted front-to-back compositing."""
    return SceneConfig(
        n_particles=64, init="grid", seed=2,
        volume=VolumeConfig(size=64, bank_size=1, noise_scale=5.5, octaves=5),
        emitter=EmitterConfig(center=(0.0, 0.0, 0.0), radius=2.2,
                              size_min=0.45, size_max=0.8,
                              life_min=1e4, life_max=1e4,
                              albedo_base=(1.0, 0.9, 0.8), albedo_var=0.35),
        camera=CameraConfig(eye=(0.0, 1.5, -7.5), look_at=(0.0, 0.0, 0.0)),
        render=RenderConfig(width=512, height=512, steps=32, engine="warp",
                            warp_fp32=False, warp_rect=272, warp_chunk=64,
                            warp_march_rect=80,
                            # K=20 px = 5.83 march cells at rect 272 (the
                            # measured du max is 5.26 cells; K scales with
                            # rect/march ratio, so rect 224->272 needed
                            # 16->20 px — same Km=6 shift taps)
                            warp_pallas=True, warp_shift_max=20,
                            max_tiles_per_particle=128, max_pairs=4096,
                            max_pairs_per_tile=48, density_scale=9.0),
    )


def c3() -> SceneConfig:
    """1k advected particles (gravity+drag+curl), per-particle 128^3 volumes,
    1080p render loop. The headline benchmark config."""
    return SceneConfig(
        n_particles=1024, init="random", seed=3,
        volume=VolumeConfig(size=128, bank_size=1024, octaves=5,
                            noise_scale=5.0),
        emitter=EmitterConfig(rate=256.0, center=(0.0, 0.0, 0.0), radius=4.5,
                              vel_base=(0.0, 0.6, 0.0), vel_spread=0.35,
                              life_min=3.0, life_max=6.0,
                              size_min=0.26, size_max=0.42,
                              albedo_base=(0.95, 0.93, 0.9), albedo_var=0.3),
        forces=ForcesConfig(gravity=(0.0, -0.25, 0.0), drag=0.35,
                            curl_strength=1.4, curl_freq=0.35),
        camera=CameraConfig(eye=(0.0, 2.5, -13.5), look_at=(0.0, 0.5, 0.0),
                            fov_y_deg=40.0),
        render=RenderConfig(width=1920, height=1080, steps=20,
                            engine="warp", warp_fp32=False, warp_rect=144,
                            warp_march_rect=80, warp_canvas_fp32=False,
                            warp_chunk=64, warp_pallas=True,
                            # slab banks x-resampled 128 -> 64 (48.9 dB
                            # vs the full-res march on device; halves
                            # the 671 MB/frame slab stream and the dot1
                            # MXU+WxT VPU work — bench/psnr_c3.py)
                            warp_slab_vx=64,
                            warp_shift_max=6,
                            tile_h=8, tile_w=32, near_fade_start=8.5,
                            near_fade_end=6.0,
                            max_tiles_per_particle=96, max_pairs=73728,
                            max_pairs_per_tile=96, density_scale=10.0),
    )


def c4() -> SceneConfig:
    """4k particles + directional light-march self-shadowing at 1080p."""
    return SceneConfig(
        n_particles=4096, init="random", seed=4,
        volume=VolumeConfig(size=64, bank_size=64, noise_scale=5.0),
        emitter=EmitterConfig(rate=1024.0, center=(0.0, 0.0, 0.0), radius=5.0,
                              vel_base=(0.0, 0.5, 0.0), vel_spread=0.3,
                              life_min=3.0, life_max=6.0,
                              size_min=0.2, size_max=0.36,
                              albedo_base=(0.95, 0.93, 0.9), albedo_var=0.25),
        forces=ForcesConfig(gravity=(0.0, -0.2, 0.0), drag=0.3,
                            curl_strength=1.2, curl_freq=0.3),
        camera=CameraConfig(eye=(0.0, 3.0, -15.0), look_at=(0.0, 0.5, 0.0),
                            fov_y_deg=40.0),
        render=RenderConfig(width=1920, height=1080, steps=20, light_steps=8,
                            engine="warp", warp_fp32=False,
                            # round-5 compound (bench/ladders/r5b_ab_c4.log,
                            # r5b_psnr_c4.log): rect 112->96 + x-downsampled
                            # banks vx=48 + grid packing pk4 measure
                            # 8.70 ms vs 9.12 base at fb48 (-4.6%), gated
                            # at 49.0 dB vs the full-res march (48 dB
                            # floor); rect 96 alone RAISES PSNR to 50.4
                            # (tighter foot_p99 rects), buying the vx=48
                            # headroom.  vx32 compounds fail the gate
                            # (47.2), rm48 compounds blow scoped VMEM.
                            warp_rect=96, warp_slab_vx=48, warp_pack=4,
                            warp_march_rect=64, light_mode="center",
                            warp_pair=1,
                            warp_canvas_fp32=False, warp_shift_max=6,
                            warp_chunk=64, warp_pallas=True, warp_mega=2048,
                            tile_h=8, tile_w=32, near_fade_start=9.5,
                            near_fade_end=7.5,
                            max_tiles_per_particle=64, max_pairs=163840,
                            max_pairs_per_tile=128, density_scale=10.0),
    )


def c5() -> SceneConfig:
    """16k particles, time-animated 4D noise density, 4K render, ray tiles
    sharded across a TPU mesh (dist/)."""
    return SceneConfig(
        n_particles=16384, init="random", seed=5,
        volume=VolumeConfig(size=64, bank_size=16, animated=True, octaves=3,
                            noise_scale=5.0),
        emitter=EmitterConfig(rate=4096.0, center=(0.0, 0.0, 0.0), radius=6.5,
                              vel_base=(0.0, 0.45, 0.0), vel_spread=0.3,
                              life_min=3.0, life_max=6.0,
                              size_min=0.18, size_max=0.32,
                              albedo_base=(0.95, 0.93, 0.9), albedo_var=0.25),
        forces=ForcesConfig(gravity=(0.0, -0.2, 0.0), drag=0.3,
                            curl_strength=1.1, curl_freq=0.28),
        camera=CameraConfig(eye=(0.0, 4.0, -19.0), look_at=(0.0, 0.5, 0.0),
                            fov_y_deg=42.0),
        render=RenderConfig(width=3840, height=2160, steps=24, light_steps=8,
                            engine="warp", warp_fp32=False, warp_rect=176,
                            warp_march_rect=80, light_mode="center",
                            warp_pair=1,
                            # window-traffic diet: at 4K/rect-176 the
                            # canvas windows dominate and the diet wins
                            # 84.7 -> 61.5 ms (-27%) at 52.9 dB vs the
                            # full-res composite (hazards no worse);
                            # the same flags LOSE at the 1080p presets
                            # (DESIGN 5g) - resolution-dependent, and
                            # the sharded combine wire shrinks ~5x
                            warp_coarse=1, warp_interleave=1,
                            warp_chunk=64, warp_pallas=True, warp_mega=2048,
                            tile_h=8, tile_w=32, near_fade_start=9.0,
                            near_fade_end=7.0,
                            max_tiles_per_particle=32, max_pairs=262144,
                            max_pairs_per_tile=96, density_scale=10.0),
    )


PRESETS = {"c1": c1, "c2": c2, "c3": c3, "c4": c4, "c5": c5}
