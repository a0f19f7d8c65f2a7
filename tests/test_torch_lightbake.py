"""volq_torch.volume.lightbake against volq.volume.lightbake: the slice
sweep for all three sweep axes and both light signs (the cases of
tests/test_slab.py::test_lightbake_matches_bruteforce_march and their
mirrors).  Tolerance 1e-5: XLA contracts the lerps' multiply-adds, the
port rounds op by op."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volq.volume import lightbake as JB
from volq_torch.convert import light_volumes_from_numpy
from volq_torch.volume import lightbake as TB

TOL = 1e-5
LIGHTS = [
    (0.3, 0.2, 0.9),      # +z sweep
    (0.5, 0.1, -0.8),     # -z sweep
    (0.9, 0.25, 0.3),     # +x sweep
    (-0.9, 0.25, 0.3),    # -x sweep
    (0.15, 0.9, 0.35),    # +y sweep
    (0.15, -0.9, 0.35),   # -y sweep
]


def _unit(L_raw):
    L = np.asarray(L_raw, np.float32)
    return L / np.linalg.norm(L)


@pytest.mark.parametrize("L_raw", LIGHTS, ids=lambda L: ",".join(map(str, L)))
def test_bake_light_volumes_matches(L_raw):
    rng = np.random.default_rng(5)
    vol = rng.random((3, 14, 14, 14), dtype=np.float32) * 0.5
    L = _unit(L_raw)
    axis = JB.dominant_axis(L_raw)
    assert TB.dominant_axis(L_raw) == axis
    ref = np.asarray(JB.bake_light_volumes(jnp.asarray(vol), jnp.asarray(L),
                                           axis=axis))
    got = TB.bake_light_volumes(torch.from_numpy(vol), torch.from_numpy(L),
                                axis=axis)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert ref.max() > 0.1
    assert np.abs(got.numpy() - ref).max() <= TOL
    # the entry face carries no depth, the far face the most
    k_in = 13 if L[axis] >= 0 else 0
    face = got.movedim((2, 3, 1)[axis], 0)
    assert float(face[k_in].abs().max()) == 0.0
    assert float(face[13 - k_in].mean()) > float(face[k_in].mean())


def test_bf16_bank_in_chunks_and_converter(monkeypatch):
    """The bank's bf16 storage is widened first; baking in chunks of
    entries equals baking at once; the converter carries a reference
    bake across unchanged."""
    rng = np.random.default_rng(6)
    vol = torch.from_numpy(rng.random((5, 8, 8, 8), dtype=np.float32)) \
        .to(torch.bfloat16)
    L = torch.from_numpy(_unit((0.4, 1.0, -0.4)))
    whole = TB.bake_light_volumes(vol, L, axis=1)
    monkeypatch.setattr(TB, "_BAKE_CHUNK", 2)
    assert torch.equal(TB.bake_light_volumes(vol, L, axis=1), whole)
    ref = np.asarray(JB.bake_light_volumes(
        jnp.asarray(vol.float().numpy(), jnp.bfloat16), jnp.asarray(L.numpy()),
        axis=1))
    assert np.abs(whole.numpy() - ref).max() <= TOL
    moved = light_volumes_from_numpy(ref)
    assert moved.dtype == torch.float32
    np.testing.assert_array_equal(moved.numpy(), ref)
