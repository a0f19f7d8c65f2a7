"""Kernel A's and B's least time, counted by hand on a tiny frame."""
import numpy as np
import pytest

from benchmark import roofline
from benchmark.reference import as_config, warp
from benchmark.tests.conftest import cell, shrink


def _geo(cfg):
    g = warp.canvas_geom(cfg, cfg.render.height)
    return dict(valid=np.array([True, True, True, False]),
                vol_idx=np.array([3, 3, 5, 7]),
                cy0=np.array([0, 10, 100, 0]), cy1=np.array([48, 58, 128, 9]),
                cx0=np.array([0, 0, 100, 0]), cx1=np.array([48, 48, 156, 9]),
                geom=g)


def test_march_and_composite_counts():
    cfg = as_config(shrink(cell("c3.steady")).config["scene"])
    r = cfg.render                 # unlit, bf16, RM 32, S 20, vx 16, V 32
    assert (r.steps, warp.march_rect(cfg), warp.slab_vx(cfg, 32)) == \
        (20, 32, 16)
    geo = _geo(cfg)
    nb, fl = roofline.march_work(cfg, geo, 16, 32)
    # 2 distinct entries x 20 slabs x 16 x 32 x 2 bytes; 3 valid particles'
    # scalars (64) and ray coordinates (2 x 32 x 4), and planes out
    assert nb == 2 * 20 * 16 * 32 * 2 + 3 * (64 + 256) + 3 * 32 * 32 * 4
    assert fl == 3 * 32 * 32 * (12 * 20 + 80)
    nb, fl = roofline.composite_work(cfg, geo)
    # cells met: 48x48 and 48x48 overlapping in 38 rows, and 28x56
    met = 48 * 48 + 10 * 48 + 28 * 56
    cells = 48 * 48 * 2 + 28 * 56
    assert nb == 2 * met * 4 * 2 + 3 * 32 * 32 * 4 + 3 * 64
    assert fl == cells * 30
    b = roofline.frame_bounds(cfg, geo, 32)
    assert b["warp_march"] == pytest.approx(max(
        roofline.march_work(cfg, geo, 16, 32)[0] / 3.35e12,
        roofline.march_work(cfg, geo, 16, 32)[1] / 67e12))


def test_lit_interleaved_counts():
    cfg = as_config(shrink(cell("c5.animated")).config["scene"])
    geo = _geo(cfg)
    nb, fl = roofline.march_work(cfg, geo, 32, 32)
    # centre-lit: one light slab per entry; two planes; 12 S + 100
    assert nb == 2 * (12 + 1) * 32 * 32 * 2 + 3 * (64 + 256) \
        + 3 * 2 * 32 * 32 * 4
    assert fl == 3 * 32 * 32 * (12 * 12 + 100)
    _, fl = roofline.composite_work(cfg, geo)
    assert fl == (48 * 48 * 2 + 28 * 56) * 76
