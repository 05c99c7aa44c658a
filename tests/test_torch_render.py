"""One whole frame through the port's ``render_frame`` on the CPU, against
the JAX package's jitted ``render_frame`` and its NumPy oracle.

Gates: PSNR ≥ 60 dB against the JAX frame (rgb and alpha rows; the two
differ by the compositor's quadratic form and float order, bounded at
1e-3 per pixel) and ≥ 40 dB against ``oracle.render_oracle`` (the JAX
package's own bar). The depth row is compared after dividing by its
largest value, at 1e-3. Stats: ``num_culled`` and ``num_instances`` equal.
The cases are split over this file and test_torch_render_more.py to keep
each file's run short.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.oracle import render_oracle
from gaussianrenderer_tpu.render import render_frame as jax_render

import gaussianrenderer_tpu_torch as gt

from test_torch_common import both_cameras, both_configs, both_scenes, np_tree, psnr_np

CASES = {
    "default": dict(scene=dict(n=2000, seed=0), cfg=dict(height=128, width=160)),
    "alpha_depth_bg_wide": dict(
        scene=dict(n=800, seed=1, scale_range=(0.05, 0.5)),
        cfg=dict(height=150, width=200, output_alpha=True, output_depth=True,
                 background=(0.2, 0.5, 1.0)),
    ),
    "spacetime": dict(scene=dict(n=900, seed=9, spacetime=True),
                      cfg=dict(height=128, width=160), time=0.37),
    "tiles16": dict(scene=dict(n=1000, seed=6),
                    cfg=dict(height=96, width=128, num_tile_x=8, num_tile_y=6)),
}


def render_both(case):
    spec = CASES[case]
    sc = dict(spec["scene"])
    js, ps = both_scenes(sc.pop("n"), **sc)
    jcfg, pcfg = both_configs(**spec["cfg"])
    # A ladder wide enough that the JAX frame drops nothing.
    jcfg = dataclasses.replace(jcfg, tier_boost=3)
    jcam, pcam, cam = both_cameras(pcfg.width, pcfg.height)
    tv = spec.get("time")
    jfb, jst = jax_render(js, jcam, jcfg, time_value=tv)
    pfb, pst = gt.render_frame(ps, pcam, pcfg, time_value=tv)
    oracle = render_oracle(js, cam, jcfg, time_value=tv)
    return np.asarray(jfb), np_tree(jst), pfb.numpy(), pst, oracle, pcfg


def check_case(case):
    jfb, jst, pfb, pst, oracle, cfg = render_both(case)
    assert pfb.shape == jfb.shape and pfb.dtype == np.float32
    assert not bool(jst.overflow) and not bool(pst.overflow)
    assert int(pst.num_culled) == int(jst.num_culled)
    assert int(pst.num_instances) == int(jst.num_instances) > 0
    np.testing.assert_array_equal(np.asarray(jst.area_hist), pst.area_hist.numpy())
    assert bool(pst.center_clipped) == bool(jst.center_clipped)
    n_img = 3 + int(cfg.output_alpha)
    assert psnr_np(pfb[:n_img], jfb[:n_img]) >= 60.0
    assert psnr_np(pfb[:n_img], oracle[:n_img]) >= 40.0
    assert np.abs(pfb[:n_img] - jfb[:n_img]).max() <= 1e-3
    if cfg.output_depth:
        scale = np.abs(jfb[-1]).max()
        assert scale > 0 and np.abs(pfb[-1] - jfb[-1]).max() / scale <= 1e-3


@pytest.mark.parametrize("case", ["default", "alpha_depth_bg_wide"])
def test_frame_matches_jax_and_oracle(case):
    check_case(case)


def test_unsupported_options_raise():
    """An unknown compositor raises. (``"xla"``, ``"diff"`` and ``"packed"``
    on a grid the packed records cannot describe render through the
    tile-sort path: tests/test_torch_render_diff.py.)"""
    ps = gt.make_random_scene(10, seed=0, device="cpu")
    _, pcam, _ = both_cameras(160, 128)
    for kw in (dict(compositor="bogus"), dict(compositor="bogus", num_tile_x=3,
                                               num_tile_y=3)):
        with pytest.raises(ValueError, match="compositor"):
            gt.render_frame(ps, pcam, gt.RenderConfig(height=128, width=160, **kw))


def test_empty_and_culled_frames_render_black():
    ps = gt.make_random_scene(20, seed=0, device="cpu")
    _, pcam, _ = both_cameras(160, 128)
    behind = ps._replace(positions=ps.positions + torch.tensor([0.0, 0.0, 50.0]))
    fb, st = gt.render_frame(behind, pcam, gt.RenderConfig(height=128, width=160))
    assert int(st.num_culled) == 0 and int(st.num_instances) == 0
    assert float(fb.abs().max()) == 0.0
    cfg = gt.RenderConfig(height=128, width=160, background=(1.0, 1.0, 1.0),
                          output_alpha=True)
    fb, _ = gt.render_frame(behind, pcam, cfg)
    assert fb.shape == (4, 128, 160)
    assert float(fb[:3].min()) == 1.0 and float(fb[3].max()) == 0.0


def test_framebuffer_to_image_and_png(tmp_path):
    fb = torch.linspace(-0.5, 1.5, 3 * 4 * 5).reshape(3, 4, 5)
    img = gt.framebuffer_to_image(fb)
    ref = np.clip(fb.numpy().transpose(1, 2, 0), 0, 1)[::-1] * 255.0 + 0.5
    np.testing.assert_array_equal(img, ref.astype(np.uint8))
    np.testing.assert_array_equal(img, gt.framebuffer_to_image(fb.numpy()))
    np.testing.assert_array_equal(
        gt.framebuffer_to_image(fb, flip_y=False), img[::-1]
    )
    path = str(tmp_path / "f.png")
    gt.save_png(fb, path)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 40
    import zlib
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    raw = zlib.decompress(idat)
    assert len(raw) == 4 * (1 + 5 * 3)
    gt.save_png(img, str(tmp_path / "g.png"))
    assert os.path.getsize(str(tmp_path / "g.png")) == len(data)
    with pytest.raises(ValueError):
        gt.save_png(np.zeros((4, 5), np.uint8), str(tmp_path / "h.png"))
