"""The roofline's counts against hand counts on a tiny frame, and the
least-time arithmetic. The counts come from the benchmark's reference."""

import math

import numpy as np
import pytest
import torch

from benchmark.metrics import _counts
from benchmark.reference import render as R


def one_splat_scene(opacity, scale, z=-4.0):
    """One isotropic grey splat straight ahead of a camera at the origin."""
    return dict(positions=torch.tensor([[0.0, 0.0, z]]), sh=torch.zeros((1, 3)),
                opacity=torch.tensor([opacity]), scales=torch.full((1, 3), scale),
                quats=torch.tensor([[1.0, 0.0, 0.0, 0.0]]))


def hand_pairs(scene, cam, geo):
    """Pixels where the splat blends: inside its 3σ box, alpha ≥ 1e-3."""
    proj = R.project(scene, cam, geo.width, geo.height, 0, True)
    cx, cy, a, b, c, op = proj.feat[0, :6].tolist()
    x0, y0, x1, y1 = proj.box[0].tolist()
    n = 0
    for y in range(geo.height):
        for x in range(geo.width):
            if not (x0 <= x <= x1 and y0 <= y <= y1):
                continue
            dx, dy = x - cx, y - cy
            alpha = min(op * math.exp(-0.5 * (a * dx * dx + b * dx * dy + c * dy * dy)), 0.99)
            n += alpha >= 1e-3
    return n, proj


@pytest.mark.parametrize("opacity,scale", [(0.9, 0.05), (0.3, 0.12), (0.05, 0.2)])
def test_pairs_of_one_splat(opacity, scale):
    geo = R.Geometry(64, 48, 16, 16)
    cam = R.look_at((0, 0, 0), (0, 0, -1), 60.0, 64 / 48, 0.2, 100.0)
    scene = one_splat_scene(opacity, scale)
    want, proj = hand_pairs(scene, cam, geo)
    counts = {}
    R.render(scene, cam, geo, 0, True, counts=counts)
    assert counts["pairs"] == want > 0
    box = proj.box[0].long().tolist()
    tiles_x = min(box[2], 63) // 16 - box[0] // 16 + 1
    tiles = tiles_x * (min(box[3], 47) // 16 - box[1] // 16 + 1)
    assert counts["instances"] == tiles


def test_an_opaque_front_splat_stops_the_pixels_behind():
    geo = R.Geometry(32, 32, 16, 16)
    cam = R.look_at((0, 0, 0), (0, 0, -1), 60.0, 1.0, 0.2, 100.0)
    front = one_splat_scene(0.99, 2.0, z=-3.0)
    back = one_splat_scene(0.9, 0.05, z=-6.0)
    both = {k: torch.cat([front[k], back[k]]) for k in front}
    alone, together = {}, {}
    R.render(front, cam, geo, 0, True, counts=alone)
    R.render(both, cam, geo, 0, True, counts=together)
    # 0.99 twice leaves T = 1e-4 < 1e-3: the back splat blends nowhere
    # the front covers at full strength, so few pairs are added.
    assert together["pairs"] - alone["pairs"] < 0.5 * alone["pairs"]


def test_least_time_takes_the_larger_bound():
    ops_bound = _counts.train_compositor_least_s(10**9, 0, 0, 0)
    assert ops_bound == pytest.approx(62e9 / 67e12)
    bytes_bound = _counts.train_compositor_least_s(0, 10**8, 0, 0)
    assert bytes_bound == pytest.approx(192e8 / 3.35e12)
    both = _counts.train_compositor_least_s(10**6, 10**6, 10**6, 100)
    assert both == pytest.approx(max(62e6 / 67e12, (192e6 + 1600 + 24e6) / 3.35e12))


def test_share_reads_nothing_without_both_readings():
    least = lambda r: 1.0  # noqa: E731
    assert _counts.share_pct([], least) is None
    assert _counts.share_pct([{"kernel_s": None, "pairs": 3}], least) is None
    assert _counts.share_pct([{"kernel_s": 4.0, "pairs": 3}], least) == 25.0


def test_kernel_names():
    assert _counts.is_train_compositor("void bwd_suffix_kernel(GrTrainArgs)")
    assert not _counts.is_train_compositor("tile_kernel(Args)")
    assert np.isfinite(_counts.FP32_FLOPS)
