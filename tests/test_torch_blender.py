"""The port's Blender / NeRF-synthetic ingestion (``scene/blender.py``) and
the transforms branches of ``train.load_views``/``dataset_image_shape``
against the JAX package's on the CPU, on ``tests/test_blender.py``'s
cases.

Gates: every camera field and every target bit-equal to JAX's (the same
PIL calls and LANCZOS filter), times equal, for the three FOV encodings
and a frame-level override, RGBA over no, white and a coloured
background, a same-aspect downscale, ``fl_y`` without meta ``h``/``w``,
D-NeRF times with strides, split selection, an RGB image named with its
extension; the aspect guard, a missing split and ``split=`` on a
``poses.json`` dataset raise alike; four ``fit_scene`` steps on Blender
views within 1e-4 relative of JAX's losses.
"""

import json
import math
import os

import numpy as np
import pytest
from PIL import Image

from gaussianrenderer_tpu import train as jtrain
from gaussianrenderer_tpu.config import RenderConfig as JaxConfig
from gaussianrenderer_tpu.config import parse_color
from gaussianrenderer_tpu.scene import blender as jblender
from gaussianrenderer_tpu.scene.io import make_random_scene as jax_make_scene

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.convert import to_torch_params
from gaussianrenderer_tpu_torch.scene import blender

from test_blender import H, W, _c2w_opengl, _rgba, _write_dataset
from test_torch_colmap import assert_views_equal
from test_torch_common import np_tree, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

C2W = _c2w_opengl((0, 0, 4), (0, 0, 0))


def both_views(d, h=H, w=W, background=None, **kw):
    """load_views of one dataset in both packages, checked equal."""
    pviews = gt.load_views(d, gt.RenderConfig(height=h, width=w, background=background),
                           device="cpu", **kw)
    jviews = jtrain.load_views(d, JaxConfig(height=h, width=w, background=background), **kw)
    assert_views_equal(pviews, jviews)
    return pviews


def noisy_rgba(h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 4)).astype(np.uint8)


def test_camera_and_target_match_jax(tmp_path):
    img = _rgba((10, 200, 30))
    img[0, 0, :3] = (255, 0, 0)
    d = _write_dataset(tmp_path, {"camera_angle_x": 0.9, "frames": [
        {"file_path": "./train/r_0",
         "transform_matrix": _c2w_opengl((1.0, 2.0, 3.0), (0.0, 0.5, 0.0)),
         "near": 0.3, "far": 40.0}]}, {"train/r_0": img})
    (cam, target), = both_views(d)
    assert target.shape == (3, H, W)
    np.testing.assert_allclose(target[:, H - 1, 0].numpy(), [1.0, 0.0, 0.0], atol=1e-6)
    assert float(cam.near) == pytest.approx(0.3)


@pytest.mark.parametrize("case", range(4))
def test_fov_encodings_match_jax(tmp_path, case):
    fov_y = 2 * math.atan(math.tan(0.45) * H / W)
    meta, frame_extra = [
        ({"camera_angle_x": 0.9}, {}),
        ({"camera_angle_y": fov_y}, {}),
        ({"fl_y": H / (2 * math.tan(fov_y / 2)), "h": H, "w": W}, {}),
        ({"camera_angle_x": 2.5}, {"camera_angle_x": 0.9}),  # the frame's key wins
    ][case]
    meta["frames"] = [dict(file_path="r_0", transform_matrix=C2W, **frame_extra)]
    d = _write_dataset(tmp_path, meta, {"r_0": _rgba((9, 9, 9))})
    assert float(both_views(d)[0][0].fov_y) == pytest.approx(math.degrees(fov_y), rel=1e-6)
    assert blender._fov_y_deg(meta, meta["frames"][0], H, W) == \
        jblender._fov_y_deg(meta, meta["frames"][0], H, W)


def test_missing_intrinsics_raise(tmp_path):
    d = _write_dataset(tmp_path, {"frames": [{"file_path": "r_0", "transform_matrix": C2W}]},
                       {"r_0": _rgba((9, 9, 9))})
    with pytest.raises(ValueError, match="intrinsics"):
        gt.load_views(d, gt.RenderConfig(height=H, width=W), device="cpu")


@pytest.mark.parametrize("background", [None, "white", "0.2,0.4,0.6"])
def test_rgba_over_background_matches_jax(tmp_path, background):
    d = _write_dataset(tmp_path, {"camera_angle_x": 0.9, "frames": [
        {"file_path": "r_0", "transform_matrix": C2W}]}, {"r_0": noisy_rgba(H, W, 1)})
    both_views(d, background=parse_color(background))


def test_downscale_and_aspect_guard_match_jax(tmp_path):
    """A 2× capture resized with LANCZOS before the alpha composite; the
    meta's h/w and the image agree."""
    d = _write_dataset(tmp_path, {"camera_angle_x": 0.9, "h": 2 * H, "w": 2 * W, "frames": [
        {"file_path": "r_0", "transform_matrix": C2W},
        {"file_path": "r_1", "transform_matrix": _c2w_opengl((1, 0, 4), (0, 0, 0))}]},
        {"r_0": noisy_rgba(2 * H, 2 * W, 2), "r_1": noisy_rgba(2 * H, 2 * W, 3)})
    both_views(d, background=(1.0, 1.0, 1.0))
    assert gt.dataset_image_shape(d) == jtrain.dataset_image_shape(d) == (2 * H, 2 * W)
    for mod, cfg in ((gt, gt.RenderConfig(height=H, width=2 * W)),
                     (jtrain, JaxConfig(height=H, width=2 * W))):
        kw = {"device": "cpu"} if mod is gt else {}
        with pytest.raises(ValueError, match="aspect"):
            mod.load_views(d, cfg, **kw)


def test_fl_y_without_meta_hw_matches_jax(tmp_path):
    fov_y = 2 * math.atan(math.tan(0.45) * H / W)
    d = _write_dataset(tmp_path, {"fl_y": (2 * H) / (2 * math.tan(fov_y / 2)), "frames": [
        {"file_path": "r_0", "transform_matrix": C2W}]}, {"r_0": noisy_rgba(2 * H, 2 * W, 4)})
    (small, _), = both_views(d)
    (native, _), = both_views(d, h=2 * H, w=2 * W)
    np.testing.assert_allclose(small.proj.numpy(), native.proj.numpy(), rtol=1e-6)
    assert gt.dataset_image_shape(d) == (2 * H, 2 * W)


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_dnerf_time_and_stride_match_jax(tmp_path, stride):
    frames = [{"file_path": f"r_{i}", "time": i / 3.0,
               "transform_matrix": _c2w_opengl((0.3 * i, 0, 4), (0, 0, 0))} for i in range(4)]
    d = _write_dataset(tmp_path, {"camera_angle_x": 0.9, "frames": frames},
                       {f"r_{i}": noisy_rgba(H, W, 10 + i) for i in range(4)})
    views = both_views(d, stride=stride)
    assert [v[2] for v in views] == [i / 3.0 for i in range(0, 4, stride)]


def test_split_selection_matches_jax(tmp_path):
    meta = {"camera_angle_x": 0.9, "frames": [{"file_path": "tr", "transform_matrix": C2W}]}
    test_meta = {"camera_angle_x": 0.9, "h": H, "w": W, "frames": [
        {"file_path": "te", "transform_matrix": C2W},
        {"file_path": "te2.png", "transform_matrix": C2W}]}
    d = _write_dataset(tmp_path, meta, {"tr": _rgba((1, 1, 1)), "te": _rgba((2, 2, 2))})
    Image.fromarray(noisy_rgba(H, W, 5)[..., :3]).save(os.path.join(d, "te2.png"))  # RGB
    _write_dataset(tmp_path, test_meta, {}, name="transforms_test.json")
    assert len(both_views(d)) == 1  # the train split
    assert len(both_views(d, split="test")) == 2
    assert blender.blender_image_shape(d, split="test") == (H, W)
    for split in (None, "train", "test"):
        assert blender.find_transforms(d, split) == jblender.find_transforms(d, split)
    with pytest.raises(FileNotFoundError, match="transforms_val"):
        blender.find_transforms(d, split="val")
    os.remove(os.path.join(d, "transforms_train.json"))
    with open(os.path.join(d, "transforms.json"), "w") as fh:
        json.dump(meta, fh)
    assert blender.find_transforms(d).endswith("transforms.json")  # before test/val
    assert blender.is_blender_dir(d) and not blender.is_blender_dir(str(tmp_path / "none"))


def test_split_rejected_for_poses_datasets(tmp_path):
    with open(os.path.join(tmp_path, "poses.json"), "w") as fh:
        json.dump([], fh)
    with pytest.raises(ValueError, match="transforms"):
        gt.load_views(str(tmp_path), gt.RenderConfig(height=H, width=W), split="test",
                      device="cpu")


def test_fit_scene_on_blender_views_matches_jax(tmp_path):
    """tests/test_blender.py's fit on a transforms dataset (64 random
    splats, MSE, no densification), four steps, over a white background."""
    rng = np.random.default_rng(0)
    img = np.zeros((H, W, 4), np.uint8)
    img[..., :3] = rng.integers(0, 255, (H, W, 3))
    img[8:24, 16:32, :3] = (250, 120, 30)
    img[..., 3] = 255
    img[:4, :, 3] = 0
    d = _write_dataset(tmp_path, {"camera_angle_x": 1.1, "frames": [
        {"file_path": "r_0", "transform_matrix": _c2w_opengl((0, 0, 5), (0, 0, 0))}]},
        {"r_0": img})
    white = (1.0, 1.0, 1.0)
    jcfg = JaxConfig(height=H, width=W, background=white)
    pcfg = gt.RenderConfig(height=H, width=W, background=white)
    start = jtrain.SceneParams.from_scene(jax_make_scene(64, seed=1, extent=1.5))
    kw = dict(steps=4, densify_every=0, opacity_reset_every=0)
    _, jh = jtrain.fit_scene(jtrain.load_views(d, jcfg), jcfg, start, loss_fn=jtrain.mse_loss,
                             auto_capacity=False, **kw)
    _, ph = gt.fit_scene(gt.load_views(d, pcfg, device="cpu"), pcfg,
                         to_torch_params(np_tree(start), "cpu"), loss_fn=gt.mse_loss, **kw)
    assert len(ph["losses"]) == 4 and ph["losses"][-1] < ph["losses"][0]
    np.testing.assert_allclose(ph["losses"], jh["losses"], rtol=1e-4, atol=0)
