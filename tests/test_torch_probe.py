"""volq_torch.probe's plain versions against the JAX package's TPU probe
kernels (bench/mxu_probe.py, specs_probe.py, granule_probe.py), whose
Pallas bodies run here in interpret mode at a small size, through a
harness that repeats each module's block specs.  Inputs come from a numpy
seed and go through both.

Budgets: the staged sum and the window read-modify-write are bit-equal
(one fp32 add per element and step; adding 1.0 to a small count); the
tensor-core product is within 1e-5 of max |out| (fp32 accumulation in
another order than the fp64 plain sum).
"""
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from volq_torch import _build, probe
from volq_torch.probe import stage, tensor_core, window

BENCH = pathlib.Path(__file__).resolve().parent.parent / "bench"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These scenes are small: one intra-op thread is as fast, and does not
    fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench_module(name):
    spec = importlib.util.spec_from_file_location(f"bench_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("nacc", [1, 8])
@pytest.mark.parametrize("shape", [(16, 32, 16), (80, 128, 64)],
                         ids=["16x32x16", "80x128x64"])
def test_mma_plain_matches_pallas_body(shape, nacc):
    mxu = _bench_module("mxu_probe")
    M, K, N = shape
    R, G = 4, 3
    rng = np.random.default_rng(7)
    A = jnp.asarray(rng.standard_normal((R, M, K), dtype=np.float32),
                    jnp.bfloat16)
    B = jnp.asarray(rng.standard_normal((K, N), dtype=np.float32),
                    jnp.bfloat16)
    # time_shape's call (bench/mxu_probe.py:93-100), interpreted
    ref = pl.pallas_call(
        functools.partial(mxu._dot_kernel, R=R, NACC=nacc),
        grid=(G,),
        in_specs=[pl.BlockSpec((R, M, K), lambda g: (0, 0, 0)),
                  pl.BlockSpec((K, N), lambda g: (0, 0))],
        out_specs=pl.BlockSpec((M, N), lambda g: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
        interpret=True)(A, B)
    ref = np.asarray(ref)
    tA, tB = _bf16(A), _bf16(B)
    got = probe.mma_probe_plain(tA, tB, G, blocks=2)
    assert got.shape == (2, M, N) and got.dtype == torch.float32
    assert torch.equal(got[0], got[1])
    assert np.abs(got[0].numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    # on a CPU tensor the wrapper takes the plain version
    assert torch.equal(probe.mma_probe(tA, tB, G, nacc, blocks=2), got)
    assert _build.launches["probe_mma_launch"] == 0
    assert _build.launches["probe_mma_wgmma_launch"] == 0


def test_mma_plans_cover_the_reference_shapes():
    """Every shape of the reference's sweep has a plan the kernel takes:
    8 warps, at most 16 tiles a warp, shared memory within the block's
    limit, the accumulators that fit; K = 1280 streams in chunks."""
    assert tensor_core.SHAPES == tuple(_bench_module("mxu_probe").SHAPES)
    assert tensor_core.PIPE_SHAPES == \
        tuple(_bench_module("mxu_probe").PIPE_SHAPES)
    for _, M, K, N in tensor_core.SHAPES + tensor_core.PIPE_SHAPES:
        R, G = tensor_core.size_run(M, K, N)
        for nacc in (1, 8):
            p = tensor_core.mma_plan(R, M, K, N, nacc)
            assert p.WGM * p.WGN == 8 and p.Mp % 16 == 0 and p.Mp >= M
            assert p.WGM * p.WM * 16 >= p.Mp and p.WGN * p.WN * 16 >= N
            assert p.WM * p.WN * p.nacc <= 16
            assert p.nacc == (1 if nacc == 1 else min(8, 16 // (p.WM * p.WN)))
            assert p.smem <= tensor_core.SMEM_BYTES and K % p.KC == 0
            assert p.resident == (K < 1280)
            assert R >= 1 and G >= 8
    assert tensor_core.mma_plan(4, 120, 64, 64, 8).Mp == 128
    for bad in ((4, 64, 24, 64, 1), (4, 64, 64, 72, 1), (4, 64, 64, 64, 4),
                (1, 512, 64, 256, 1)):
        with pytest.raises(ValueError):
            tensor_core.mma_plan(*bad)


_WG_SHAPES = dict.fromkeys(tensor_core.SHAPES + tensor_core.PIPE_SHAPES)


@pytest.mark.parametrize("shape", list(_WG_SHAPES),
                         ids=[f"{t}-{M}x{K}x{N}" for t, M, K, N in _WG_SHAPES])
def test_wgmma_plans_cover_the_reference_shapes(shape):
    """The wgmma arm's plan of every shape of the reference's sweep, at the
    timed launch's stack depth: the orientation (transposed where only N
    divides by 64, padded only where neither side does), 64-row tiles that
    cover the output, a wgmma N the instruction takes, shared memory and
    accumulator registers within the block's limits, legal TMA boxes."""
    tag, M, K, N = shape
    R, _ = tensor_core.size_run(M, K, N)
    for nacc in (1, 8):
        p = tensor_core.wgmma_plan(R, M, K, N, nacc)
        assert p.trans == (tag in ("c3_dot1", "up_tlist", "up_xplace",
                                   "m_sweep_16", "m_sweep_32"))
        assert (p.pad > 0) == (tag == "c3_dot2")
        assert p.trans == (M % 64 != 0 and N % 64 == 0)
        rows, cols = (N, M) if p.trans else (M + p.pad, N)
        assert p.Tm * 64 == rows >= (N if p.trans else M) and p.n == cols
        assert p.n % 8 == 0 and 8 <= p.n <= 256
        assert p.useful == pytest.approx(M * N / (p.Tm * 64 * p.n))
        assert p.useful == (0.625 if tag == "c3_dot2" else 1.0)
        assert 2 * p.tpw >= p.Tm and p.split == (p.Tm == 1)
        assert (p.n, p.tpw, p.trans) in tensor_core.WGMMA_CONFIGS
        # accumulators: m64nN fp32 is N / 2 registers a thread
        assert p.acc_regs == p.nacc * p.tpw * p.n // 2
        assert p.acc_regs <= tensor_core.ACC_REGS
        assert p.nacc == (1 if nacc == 1 else
                          tensor_core.WGMMA_CONFIGS[(p.n, p.tpw, p.trans)])
        assert p.smem <= tensor_core.SMEM_BYTES
        # TMA: every box dimension <= 256, the inner one 128 bytes of bf16
        # (the 128-byte swizzle's span)
        for box in p.boxes:
            assert all(1 <= d <= 256 for d in box) and box[0] * 2 == 128
        assert p.boxes[0][1] == p.rowsA and p.rowsA % 8 == 0
        assert p.params["a_box"] % 1024 == 0 and p.params["b_chunk"] % 1024 \
            == 0, "swizzled tiles must start on 1024-byte boundaries"
        if p.resident:
            assert K <= 256 and p.KC == K and p.boxes[1][1] == K
        else:
            assert K == 1280 and p.KC == 64 and p.boxes[1][1] == 64
            assert p.stages >= (3 if p.split else 2)
            assert p.params["slot"] % 1024 == 0
    assert tensor_core.wgmma_plan(R, M, K, N, 1).resident == (K < 1280)


def test_wgmma_plan_refuses_what_no_instantiation_takes():
    for bad in ((4, 64, 24, 64, 1), (4, 64, 64, 72, 1), (4, 64, 64, 64, 4),
                (2, 320, 64, 64, 1), (2, 72, 64, 48, 1),
                (2, 64, 64, 48, 1)):
        with pytest.raises(ValueError):
            tensor_core.wgmma_plan(*bad)
    # the test shapes of the card tests each have a plan
    assert tensor_core.wgmma_plan(3, 16, 32, 16, 8).pad == 48
    assert tensor_core.wgmma_plan(8, 120, 64, 256, 1).tpw == 2
    assert not tensor_core.wgmma_plan(8, 80, 1280, 80, 1).resident


@pytest.mark.parametrize("mix", list(dict.fromkeys(
    [(K, s, c) for K, _, s, c in stage.SWEEP] + [(16, 4, 4)])),
    ids=lambda m: "K%d-s%d-c%d" % m)
@pytest.mark.parametrize("depth", stage.DEPTHS)
def test_stage_ring_plan(mix, depth):
    """The tma arm's ring: depth slots of K 4 KB tiles and the small
    blocks, beside the const tiles, within the block's shared memory, or
    refused; every bulk copy 16-byte sized into 16-byte-aligned slots."""
    K, small, const = mix
    need = depth * (K * 4096 + small * 64) + const * 4096
    if need > stage.SMEM_BYTES:
        with pytest.raises(ValueError):
            stage.tma_plan(K, small, const, depth)
        return
    p = stage.tma_plan(K, small, const, depth)
    assert p.depth == depth and p.smem <= stage.SMEM_BYTES
    assert p.slot >= K * 4096 + small * 64 and p.slot % 128 == 0
    assert p.smem >= need
    for nbytes, count in p.copies:
        assert nbytes % 16 == 0 and count >= 0
    # each copy's offset in a slot is a 16-byte multiple
    offs = [k * 4096 for k in range(K)] + [K * 4096 + s * 64
                                           for s in range(small)]
    assert all(o % 16 == 0 for o in offs)


def test_new_arms_on_the_cpu_run_the_plain_versions():
    """On CPU tensors the wgmma and tma arms (the defaults) return the
    plain result and launch nothing; an unknown arm, a ring shallower than
    two, a ring that does not fit and a misaligned stack are refused."""
    n0 = _build.launches.copy()
    A, B = tensor_core.make_inputs(3, 80, 128, 64, "cpu")
    ref = probe.mma_probe_plain(A, B, 2, 2)
    for arm in ("wgmma", "mma_sync"):
        assert torch.equal(probe.mma_probe(A, B, 2, 8, 2, arm), ref)
    assert torch.equal(probe.mma_probe(A, B, 2, 8, 2), ref)
    args = stage.make_inputs(2, 1, 1, "cpu", M=4)
    ref = probe.stage_probe_plain(*args, 9)
    for arm, depth in (("tma", None), ("tma", 2), ("tma", 8),
                       ("cp_async", None)):
        assert torch.equal(probe.stage_probe(*args, 9, arm, depth), ref)
    assert torch.equal(probe.stage_probe(*args, 9), ref)
    assert _build.launches == n0
    for name in ("probe_mma_launch", "probe_mma_wgmma_launch",
                 "probe_stage_launch", "probe_stage_tma_launch"):
        assert _build.launches[name] == 0
    with pytest.raises(ValueError):
        probe.mma_probe(A, B, 2, 8, 1, "wmma")
    with pytest.raises(ValueError):
        probe.stage_probe(*args, 9, "bulk")
    for depth in (0, 1, 9):
        with pytest.raises(ValueError):
            probe.stage_probe(*args, 9, "tma", depth)
    with pytest.raises(ValueError):
        probe.stage_probe(*args, 9, "cp_async", 4)
    big = stage.make_inputs(16, 4, 4, "cpu", M=2)
    # the default ring (DEPTH slots) does not fit either: no shallower one
    # is chosen in its place
    for depth in (stage.DEPTH, None):
        with pytest.raises(ValueError):
            probe.stage_probe(*big, 3, "tma", depth)
    xs, sm, cs = args
    shifted = torch.zeros(4 * 8 * 128 + 1)[1:].view(4, 8, 128)
    shifted.copy_(xs[0])
    with pytest.raises(ValueError):
        probe.stage_probe([shifted, xs[1]], sm, cs, 9, "tma")
    assert torch.equal(probe.stage_probe([shifted, xs[1]], sm, cs, 9,
                                         "cp_async"), ref)
    Ash = torch.zeros(A.numel() + 1, dtype=torch.bfloat16)[1:].view(A.shape)
    Ash.copy_(A)
    with pytest.raises(ValueError):
        probe.mma_probe(Ash, B, 2, 8, 1, "wgmma")


def _capture_specs_kernel(monkeypatch, specs):
    """specs_probe builds its kernel inside ``run``: run it once at the
    smallest size with ``pl.pallas_call`` watched, and keep the body."""
    seen = []

    class Watch:
        def __getattr__(self, name):
            return getattr(pl, name)

        def pallas_call(self, kernel, **kw):
            seen.append(kernel)
            return pl.pallas_call(kernel, **kw)

    monkeypatch.setattr(specs, "pl", Watch())
    specs.run(1, 2, reps=1)
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("mix", [(2, 0, 0), (2, 3, 0), (1, 0, 4)],
                         ids=["K2", "K2+small3", "K1+const4"])
def test_stage_plain_matches_pallas_body(monkeypatch, capsys, mix):
    specs = _bench_module("specs_probe")
    kernel = _capture_specs_kernel(monkeypatch, specs)
    K, small, const = mix
    M, G = 8, 16
    rng = np.random.default_rng(11)
    xs = [rng.random((M, 8, 128), dtype=np.float32) for _ in range(K)]
    sm = [rng.random((M, 1, 16), dtype=np.float32) for _ in range(small)]
    cs = [rng.random((M, 8, 128), dtype=np.float32) for _ in range(const)]
    # run's specs (bench/specs_probe.py:46-58) at this M and G
    in_specs = [pl.BlockSpec((1, 8, 128), lambda n, s: (n % M, 0, 0),
                             memory_space=pltpu.VMEM) for _ in range(K)]
    in_specs += [pl.BlockSpec((1, 1, 16), lambda n, s: (n % M, 0, 0),
                              memory_space=pltpu.SMEM) for _ in range(small)]
    in_specs += [pl.BlockSpec((1, 8, 128), lambda n, s: (0, 0, 0),
                              memory_space=pltpu.VMEM) for _ in range(const)]
    ref = pl.pallas_call(
        kernel, grid=(G, 1), in_specs=in_specs,
        out_specs=pl.BlockSpec((8, 128), lambda n, s: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)(*map(jnp.asarray, xs + sm + cs))
    t = lambda arrs: [torch.from_numpy(a) for a in arrs]  # noqa: E731
    got = probe.stage_probe_plain(t(xs), t(sm), t(cs), G)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert torch.equal(probe.stage_probe(t(xs), t(sm), t(cs), G), got)
    # the sum wraps around the stack: G = 2 M steps see every block twice
    want = np.zeros((8, 128), np.float32)
    for n in range(G):
        want = want + xs[0][n % M]
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("align", [128, 16, 8, 4, 1])
def test_window_plain_matches_pallas_body(align):
    gran = _bench_module("granule_probe")
    H, W, N = 64, 512, 32
    off = window.make_offsets(align, N, H, W, seed=3)
    # run's call (bench/granule_probe.py:81-95) on a small canvas
    ref = pl.pallas_call(
        functools.partial(gran._kernel, align=align),
        grid=(N,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.ANY),
        out_shape=jax.ShapeDtypeStruct((H, W), jnp.float32),
        input_output_aliases={1: 0},
        scratch_shapes=[
            pltpu.VMEM((2, gran.WH, gran.WW), jnp.float32),
            pltpu.SemaphoreType.DMA((2,)),
            pltpu.SemaphoreType.DMA((2,)),
        ],
        interpret=True)(jnp.asarray(off), jnp.zeros((H, W), jnp.float32))
    toff = torch.from_numpy(off)
    got = probe.window_probe_plain(torch.zeros((H, W)), toff, align)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert float(got.max()) >= 2.0, "no two windows overlap"
    assert float(got.sum()) == N * 8 * 128
    for arm in window.ARMS:
        if align in window.ALIGNS[arm]:
            assert torch.equal(probe.window_probe(
                torch.zeros((H, W)), toff, align, arm=arm), got)


def test_window_offsets_are_the_reference_s():
    """make_offsets repeats granule_probe.run's draw (same seed, same
    order), so the card is asked about the same windows."""
    gran = _bench_module("granule_probe")
    assert (window.H, window.W, window.WH, window.WW, window.N) == \
        (gran.H, gran.W, gran.WH, gran.WW, gran.N)
    for align in (128, 16, 8):
        rng = np.random.RandomState(0)
        ys = rng.randint(0, (gran.H - gran.WH) // 8, size=gran.N) * 8
        xs = rng.randint(0, (gran.W - gran.WW) // align, size=gran.N) * align
        off = window.make_offsets(align)
        assert off.dtype == np.int32 and off.shape == (2 * gran.N,)
        np.testing.assert_array_equal(off[0::2], ys)
        np.testing.assert_array_equal(off[1::2], xs)


def test_window_cells_touched_counts_overlap_once():
    """The bytes a window run must move: every covered cell once, however
    many windows cover it; and the library call's form of the function,
    one index_add_ of ones at every window's cell indices, bit-equal to
    the ordered loop."""
    off = torch.from_numpy(window.make_offsets(8, 32, 64, 512, seed=3))
    counts = probe.window_probe_plain(torch.zeros((64, 512)), off, 8)
    touched = window.cells_touched(off, 512)
    assert touched == int((counts > 0).sum()) < 32 * 8 * 128
    assert window.cells_touched(off[:2], 512) == 8 * 128
    idx = window.cell_index(off, 512)
    assert idx.dtype == torch.int64 and idx.numel() == 32 * 8 * 128
    lib = torch.zeros(64 * 512).index_add_(0, idx, torch.ones(idx.numel()))
    assert torch.equal(lib.view(64, 512), counts)
    # no windows: nothing to do, and the launch count stays as it was
    before = _build.launches.copy()
    empty = torch.zeros(0, dtype=torch.int32)
    assert float(probe.window_probe(torch.zeros((64, 512)), empty, 8).sum()) \
        == 0.0
    assert _build.launches == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    A, B = tensor_core.make_inputs(2, 32, 32, 32, "cpu")
    with pytest.raises(TypeError):
        probe.mma_probe(A.float(), B, 1)
    with pytest.raises(ValueError):
        probe.mma_probe(A, B[:16], 1)
    with pytest.raises(ValueError):
        probe.mma_probe(A.transpose(1, 2), B, 1)
    xs, sm, cs = stage.make_inputs(2, 1, 1, "cpu", M=4)
    with pytest.raises(ValueError):
        probe.stage_probe([], sm, cs, 4)
    with pytest.raises(ValueError):
        probe.stage_probe(xs, [sm[0][:, :, :8]], cs, 4)
    with pytest.raises(TypeError):
        probe.stage_probe([x.double() for x in xs], sm, cs, 4)
    with pytest.raises(ValueError):
        probe.stage_probe(xs, sm, [cs[0][:2]], 4)
    canvas = torch.zeros((64, 512))
    off = torch.from_numpy(window.make_offsets(8, 16, 64, 512))
    for bad in (dict(align=16), dict(align=2, arm="cp_async"),
                dict(align=8, arm="wgmma")):
        with pytest.raises(ValueError):
            probe.window_probe(canvas, off, **bad)
    with pytest.raises(ValueError):
        probe.window_probe(canvas, off + 60, 4)
    with pytest.raises(TypeError):
        probe.window_probe(canvas, off.long(), 8)


def test_window_chain_length():
    """The chain that bounds the window probe: N identical windows are a
    chain of N, disjoint ones of 1; windows overlap when |dx| < 128 and
    |dy| < 8; the reference's offsets give chains of 8 / 12 / 12 / 11 at
    align 128 / 16 / 8 / 4."""
    def off(*yx):
        return np.asarray(yx, np.int32).reshape(-1)

    assert window.chain_length(off(*[(8, 40)] * 7)) == 7
    assert window.chain_length(off((0, 0), (0, 128), (8, 0), (8, 256))) == 1
    assert window.chain_length(off((16, 0), (16, 127))) == 2
    assert window.chain_length(off((16, 127), (16, 0))) == 2
    assert window.chain_length(off((16, 0), (16, 128))) == 1
    assert window.chain_length(off((16, 0), (20, 0), (24, 0))) == 3
    assert window.chain_length(off((16, 0), (24, 0))) == 1
    # a chain follows the order given: the third overlaps the first two
    assert window.chain_length(off((0, 0), (0, 200), (0, 100))) == 2
    assert window.chain_length(np.zeros(0, np.int32)) == 0
    assert window.chain_length(torch.from_numpy(off((0, 0), (0, 1)))) == 2
    for align, want in ((128, 8), (16, 12), (8, 12), (4, 11)):
        assert window.chain_length(window.make_offsets(align)) == want


@pytest.mark.parametrize("align", [128, 16, 4, 2, 1])
def test_window_overlap_cases(align):
    """The card's heavy-overlap cases: inside the canvas, y 8-aligned, x
    ``align``-aligned (taken by each arm that takes the alignment), each
    as deep a chain as it claims; the wrapper runs them as the loop does."""
    n, h, w = 96, 64, 512
    cases = window.overlap_cases(align, n, h, w, seed=5)
    assert set(cases) == {"one_band", "identical", "dense", "edges"}
    for name, o in cases.items():
        ys, xs = o[0::2], o[1::2]
        assert o.dtype == np.int32 and o.shape == (2 * n,), name
        assert (ys % 8 == 0).all() and (ys >= 0).all() and \
            (ys <= h - 8).all(), name
        assert (xs % align == 0).all() and (xs >= 0).all() and \
            (xs <= w - 128).all(), name
        toff = torch.from_numpy(o)
        ref = probe.window_probe_plain(torch.zeros((h, w)), toff, align)
        for arm in window.ARMS:
            if align in window.ALIGNS[arm]:
                assert torch.equal(probe.window_probe(
                    torch.zeros((h, w)), toff, align, arm=arm), ref), name
    assert len(set(cases["one_band"][0::2])) == 1
    assert window.chain_length(cases["identical"]) == n
    # dense: most windows overlap one of the 7 before them in their band
    # (in flight at once on the card)
    ys, xs = cases["dense"][0::2], cases["dense"][1::2]
    near = 0
    for y in set(ys):
        b = xs[ys == y].astype(int)
        near += sum(any(abs(b[i] - b[j]) < 128 for j in range(max(0, i - 7), i))
                    for i in range(len(b)))
    assert near > n // 2
    assert set(cases["edges"][1::2]) == {0, w - 128}


def test_window_probe_arms_and_bands():
    """The wrapper takes y only in multiples of 8 (one block walks one
    8-row band), on both arms; the cp_async arm takes x only in multiples
    of 4 elements (16-byte copies), the tma arm any x."""
    h, w = 32, 256
    canvas = torch.zeros((h, w))
    for arm in window.ARMS:
        with pytest.raises(ValueError, match="multiple of 8"):
            probe.window_probe(canvas, torch.tensor([4, 0], dtype=torch.int32),
                               4, arm=arm)
    off = torch.tensor([0, 3, 8, 2, 0, 1, 24, 128], dtype=torch.int32)
    for align in (2, 1):
        with pytest.raises(ValueError, match="cp_async"):
            probe.window_probe(canvas, off, align, arm="cp_async")
    with pytest.raises(ValueError, match="1-aligned|2-aligned"):
        probe.window_probe(canvas, off, 2, arm="tma")
    got = probe.window_probe(torch.zeros((h, w)), off, 1, arm="tma")
    assert torch.equal(got, probe.window_probe_plain(torch.zeros((h, w)),
                                                     off, 1))
    assert float(got[0, 3]) == 2.0 and float(got[8, 2]) == 1.0
    assert float(got[31, 255]) == 1.0 and float(got[0, 0]) == 0.0
    with pytest.raises(ValueError, match="width"):
        probe.window_probe(torch.zeros((h, 258)), off, 1)


def test_probe_entry_point_needs_the_card(monkeypatch, capsys):
    from volq_torch.probe.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["stage"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["bogus"])
