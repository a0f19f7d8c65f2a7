"""volq_torch's light kernel (``csrc/light_bake.cu``, wrapped by
``volume/lightbake.light_bake``): the CPU's dispatch and the wrapper's
refusals here, and on the card the kernel held bit-equal to the plain
sweep (``_bake_light_plain``) on the card.  Imports neither JAX nor volq,
so the card cases run where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_light_kernel.py -q

The card cases: the six (axis, sign) lights of
``tests/test_torch_lightbake.py``, V 8, 14, 64 and 128 (the vector path
of a y sweep at V 8 and 64, the scalar path elsewhere), 3, 16 and 64
entries, bf16 and fp32 banks; the entry face exactly 0; the launch count
one a call; V above 128 refused.  Without a card they skip (the kernel
has no CPU mode).
"""
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from volq_torch import _build
from volq_torch.core import trace
from volq_torch.scene.config import RenderConfig, SceneConfig
from volq_torch.volume import lightbake as TB

LIGHTS = [
    (0.3, 0.2, 0.9),      # +z sweep
    (0.5, 0.1, -0.8),     # -z sweep
    (0.9, 0.25, 0.3),     # +x sweep
    (-0.9, 0.25, 0.3),    # -x sweep
    (0.15, 0.9, 0.35),    # +y sweep
    (0.15, -0.9, 0.35),   # -y sweep
]


def _unit(L_raw, device):
    L = torch.tensor(L_raw, dtype=torch.float32)
    return (L / torch.linalg.vector_norm(L)).to(device)


def _bank(m, v, dtype, device, seed=0):
    """Densities in [0, 0.5) with carved zeros, as a bank holds."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((m, v, v, v), generator=g, device=device)
    return torch.where(x < 0.3, 0.0, 0.5 * x).to(dtype)


def _refuse(*args, **kwargs):
    raise AssertionError("the light kernel reached")


def test_cpu_bank_takes_the_plain_path_and_counts_light_torch(monkeypatch):
    vol = _bank(3, 8, torch.bfloat16, "cpu")
    L = _unit(LIGHTS[4], "cpu")
    plain = TB._bake_light_plain(vol, L, axis=1)
    monkeypatch.setattr(_build, "launch", _refuse)
    monkeypatch.setattr(TB, "light_bake", _refuse)

    class _Light:
        direction = L

    cfg = SceneConfig(render=RenderConfig(engine="warp", light_steps=8))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = TB.render_light_volumes(vol, _Light, cfg)
    assert trace.counters() == {("volq.bake.light", "light_torch"): 1}
    trace.reset()
    assert torch.equal(got, plain)


def test_light_kernel_is_built_with_the_others():
    assert "light_bake" in _build.SOURCES
    src = (_build.CSRC / "light_bake.cu").read_text()
    assert TB._MAX_V == int(re.search(r"kMaxV = (\d+);", src).group(1))
    (params,) = re.findall(r'extern "C" int light_bake_launch\((.*?)\)',
                           src, re.S)
    assert len(params.split(",")) == len(TB._LIGHT_ARGS)


_V8 = (2, 8, 8, 8)


@pytest.mark.parametrize("shape, dtype, axis, light, match", [
    ((2, 8, 8, 4), torch.float32, 1, None, "shape"),
    ((2, 8, 8), torch.float32, 1, None, "shape"),
    ((2, 129, 129, 129), torch.bfloat16, 1, None, "V <= 128"),
    ((2, 1, 1, 1), torch.float32, 1, None, "2 <= V"),
    (_V8, torch.float32, 3, None, "axis"),
    (_V8, torch.float16, 1, None, "dtype"),
    ("strided", torch.float32, 1, None, "contiguous"),
    (_V8, torch.float32, 1, torch.float64, "dtype"),
    (_V8, torch.float32, 1, "short", "shape"),
    (_V8, torch.float32, 1, None, "CUDA device"),
], ids=["plane", "dims", "V129", "V1", "axis", "fp16", "strided",
        "light-fp64", "light-shape", "cpu"])
def test_the_wrapper_refuses_before_building(monkeypatch, shape, dtype,
                                             axis, light, match):
    monkeypatch.setattr(_build, "launch", _refuse)
    if shape == "strided":
        vol = torch.zeros((2, 8, 8, 16), dtype=dtype)[..., ::2]
    else:
        vol = torch.zeros(shape, dtype=dtype)
    L = torch.zeros(3)
    if light == "short":
        L = torch.zeros(2)
    elif light is not None:
        L = L.to(light)
    with pytest.raises((TypeError, ValueError), match=match):
        TB.light_bake(vol, L, axis)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the light kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("m", [3, 16, 64])
@pytest.mark.parametrize("v", [8, 14, 64, 128])
@pytest.mark.parametrize("L_raw", LIGHTS, ids=lambda L: ",".join(map(str, L)))
def test_kernel_equals_the_plain_sweep_on_the_card(card, L_raw, v, m, dtype):
    vol = _bank(m, v, dtype, card, seed=v * 1000 + m)
    L = _unit(L_raw, card)
    axis = TB.dominant_axis(L_raw)
    n0 = _build.launches["light_bake_launch"]
    got = TB.bake_light_volumes(vol, L, axis)
    assert _build.launches["light_bake_launch"] == n0 + 1
    want = TB._bake_light_plain(vol, L, axis)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert float(want.max()) > 0.0
    # the entry face carries no depth
    k_in = v - 1 if float(L[axis]) >= 0 else 0
    face = got.movedim((2, 3, 1)[axis], 1)[:, k_in]
    assert float(face.abs().max()) == 0.0


@pytest.mark.gpu
def test_kernel_counts_a_launch_a_call_and_refuses_v_above_128(card):
    L = _unit(LIGHTS[4], card)
    vol = _bank(2, 16, torch.bfloat16, card)
    n0 = _build.launches["light_bake_launch"]
    for i in range(1, 4):
        TB.light_bake(vol, L, 1)
        assert _build.launches["light_bake_launch"] == n0 + i
    big = torch.zeros((1, 129, 129, 129), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="V <= 128"):
        TB.light_bake(big, L, 1)
    with pytest.raises(ValueError, match="on cpu"):
        TB.light_bake(vol, L.cpu(), 1)
    assert _build.launches["light_bake_launch"] == n0 + 3
