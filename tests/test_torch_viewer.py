"""The port's viewer session (``gaussianrenderer_tpu_torch.viewer``) held
against the JAX package's Canvas on the CPU: the same seeded scene and the
same camera calls on both sides. ``tests/test_viewer.py``'s Canvas cases,
with the port's state and images compared to JAX's.

Tolerances: camera state after orbit and zoom is equal (both keep the
same NumPy camera math); ``UiSettings.clamp`` is equal field by field;
``draw()`` images are at most 1 level apart in rgb and at most 2 in the
depth view, whose min-max scaling amplifies the framebuffers' float
differences.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from gaussianrenderer_tpu.config import UiSettings as JaxUiSettings
from gaussianrenderer_tpu.scene.compact import save_compact, save_splat
from gaussianrenderer_tpu.scene.io import make_random_scene as jax_make_scene
from gaussianrenderer_tpu.scene.io import save_ply
from gaussianrenderer_tpu.viewer import Canvas as JaxCanvas
from gaussianrenderer_tpu.viewer import OrbitControls as JaxOrbitControls

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch import viewer
from gaussianrenderer_tpu_torch.viewer import Canvas, FrameTimer, OrbitControls

from test_torch_common import both_scenes, one_torch_thread  # noqa: F401

RGB_LEVELS = 1
DEPTH_LEVELS = 2


def _setup(c, h, w):
    c.camera.set_position([0.0, 0.0, 6.0])
    c.camera.set_clipping_planes(0.2, 100.0)
    c.camera.set_aspect_ratio(w / h)
    c.camera.update_camera_matrices()


def _canvases(h=96, w=128, n=500, compositor="xla", seed=0, **scene_kw):
    """(JAX Canvas, port Canvas on the CPU) on the same seeded scene."""
    jc = JaxCanvas(height=h, width=w, compositor=compositor)
    pc = Canvas(height=h, width=w, compositor=compositor, device="cpu")
    js, ts = both_scenes(n, seed=seed, **scene_kw)
    for c, s in ((jc, js), (pc, ts)):
        c.init(prewarm=False)
        _setup(c, h, w)
        c.set_scene(s)
    return jc, pc


def _close(a, b, levels):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16)).max()
    assert diff <= levels, diff


def _same_camera(jcam, pcam):
    for name in ("position", "look_at", "view", "proj", "r_cam", "plane_normals"):
        np.testing.assert_array_equal(getattr(pcam, name), getattr(jcam, name), err_msg=name)


def test_render_and_draw():
    jc, pc = _canvases()
    fb, stats = pc.render()
    assert fb.shape == (3, 96, 128) and fb.device.type == "cpu"
    img = pc.draw()
    assert img.shape == (96, 128, 3) and img.dtype == np.uint8 and img.max() > 0
    jc.render()
    _close(img, jc.draw(), RGB_LEVELS)


def test_flip_y_setting():
    jc, pc = _canvases()
    pc.render()
    jc.render()
    for flip in (True, False):
        pc.settings.flip_y = jc.settings.flip_y = flip
        _close(pc.draw(), jc.draw(), RGB_LEVELS)
    pc.settings.flip_y = True
    a = pc.draw()
    pc.settings.flip_y = False
    np.testing.assert_array_equal(a, pc.draw()[::-1])


def test_resize_switches_resolution():
    jc, pc = _canvases()
    for c in (jc, pc):
        c.render()
        c.on_resize(64, 160)
    fb, _ = pc.render()
    assert fb.shape == (3, 64, 160)
    assert pc.camera.aspect == jc.camera.aspect and abs(pc.camera.aspect - 160 / 64) < 1e-6
    jc.render()
    _close(pc.draw(), jc.draw(), RGB_LEVELS)


def test_orbit_drag_and_zoom_match_jax():
    """A 20 px drag (5° at 0.25°/px) keeps the distance to look_at; a
    scroll zooms along the view axis; the camera equals JAX's after each."""
    jc, pc = _canvases()
    pos0 = pc.camera.position.copy()
    for c in (jc, pc):
        c.on_mouse_button(True, 10.0, 10.0)
        c.on_cursor(30.0, 10.0)
        c.on_mouse_button(False)
        c.on_cursor(60.0, 40.0)  # released: no orbit
    assert not np.allclose(pc.camera.position, pos0)
    r0 = np.linalg.norm(pos0 - pc.camera.look_at)
    r1 = np.linalg.norm(pc.camera.position - pc.camera.look_at)
    assert abs(r0 - r1) < 1e-4
    _same_camera(jc.camera, pc.camera)
    for c in (jc, pc):
        c.on_scroll(1.0)
    assert np.linalg.norm(pc.camera.position - pc.camera.look_at) != r1
    _same_camera(jc.camera, pc.camera)
    pc.render()
    jc.render()
    _close(pc.draw(), jc.draw(), RGB_LEVELS)


def test_k_sigma_affects_image():
    jc, pc = _canvases()
    imgs = []
    for k in (0.5, 6.0):
        pc.settings.k_sigma = jc.settings.k_sigma = k
        pc.render()
        jc.render()
        imgs.append(pc.draw())
        _close(imgs[-1], jc.draw(), RGB_LEVELS)
    assert not np.array_equal(*imgs)


def test_set_fov_matches_jax():
    jc, pc = _canvases()
    for fov in (80.0, 1.0, 500.0):
        jc.set_fov(fov)
        pc.set_fov(fov)
        assert pc.settings.fov_y == jc.settings.fov_y
        _same_camera(jc.camera, pc.camera)


@pytest.mark.parametrize("fields", [
    {"k_sigma": 100.0, "fov_y": 1.0},
    {"k_sigma": -3.0, "fov_y": 400.0, "view_mode": "bogus"},
    {"num_tile_x": 7, "num_tile_y": 3},
    {"num_tile_x": 7, "num_tile_y": 3, "lock_tiles": False, "view_mode": "depth"},
    {"time_value": 0.25, "flip_y": False},
])
def test_settings_clamp_matches_jax(fields):
    """UiSettings: the same defaults, and clamp() leaves every field
    equal to the JAX settings' on the same input."""
    assert dataclasses.asdict(gt.UiSettings()) == dataclasses.asdict(JaxUiSettings())
    ours, theirs = gt.UiSettings(**fields), JaxUiSettings(**fields)
    ours.clamp()
    theirs.clamp()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_canvas_depth_view_mode():
    """view_mode='depth' renders the alpha and depth rows and draws a
    gray normalized depth image (within 2 levels of JAX's); rgb mode
    returns to 3 rows; clamp() rejects unknown modes."""
    jc, pc = _canvases()
    for c in (jc, pc):
        c.settings.view_mode = "depth"
        c.render()
    assert pc._fb.shape == (5, 96, 128)
    img = pc.draw()
    np.testing.assert_array_equal(img[..., 0], img[..., 1])
    np.testing.assert_array_equal(img[..., 1], img[..., 2])
    assert img.max() > 0
    _close(img, jc.draw(), DEPTH_LEVELS)
    pc.settings.view_mode = "rgb"
    fb2, _ = pc.render()
    assert fb2.shape == (3, 96, 128)
    pc.settings.view_mode = "bogus"
    pc.settings.clamp()
    assert pc.settings.view_mode == "rgb"


def test_canvas_rgb_draw_with_extra_output_rows():
    """A base config with alpha and depth rows renders 5 rows; the rgb
    draw shows the colour rows only."""
    jc, pc = _canvases()
    for c in (jc, pc):
        c._base_cfg = dataclasses.replace(c._base_cfg, output_alpha=True, output_depth=True)
        c.render()
    assert pc._fb.shape == (5, 96, 128)
    img = pc.draw()
    assert img.max() > 0
    _close(img, jc.draw(), RGB_LEVELS)


def test_canvas_time_scrub_changes_frame():
    """UiSettings.time_value slices a 4D scene: two times render different
    frames, each within 1 level of JAX's; a static scene ignores it."""
    jc, pc = _canvases(64, 96, n=400, seed=3, spacetime=True)
    imgs = []
    for t in (0.0, 1.0):
        pc.settings.time_value = jc.settings.time_value = t
        pc.render()
        jc.render()
        imgs.append(pc.draw())
        _close(imgs[-1], jc.draw(), RGB_LEVELS)
    assert not np.array_equal(*imgs)

    c2 = Canvas(height=64, width=96, compositor="xla", device="cpu")
    c2.set_scene(gt.make_random_scene(400, seed=3, device="cpu"))
    c2.settings.time_value = 0.5  # no time_params: ignored
    fb, _ = c2.render()
    assert fb.shape == (3, 64, 96)


def test_prewarm_thread_ends_and_resize_renders():
    """init(prewarm=True) starts the prewarm thread, which ends without
    an error (on the CPU there is nothing to build); the resize bucket
    renders."""
    cv = Canvas(height=96, width=128, device="cpu")
    cv.init(prewarm=True, resize_buckets=((64, 96),))
    cv.set_scene(gt.make_random_scene(300, seed=3, device="cpu"))
    assert cv._prewarm_thread is not None
    cv._prewarm_thread.join(timeout=60)
    assert not cv._prewarm_thread.is_alive() and cv._prewarm_error is None
    cv.on_resize(64, 96)
    cv._base_cfg = dataclasses.replace(cv._base_cfg, compositor="xla")
    fb, _ = cv.render()
    assert fb.shape == (3, 64, 96)


def test_prewarm_library_is_the_compositors():
    """The prewarm loads the library of the canvas's compositor, one a
    compositor (the xla compositor has none), and each is a kernel
    source the build knows."""
    from gaussianrenderer_tpu_torch import _build

    assert viewer.COMPOSITOR_LIBRARY == {"packed": "tile_render2", "diff": "tile_train"}
    assert set(viewer.COMPOSITOR_LIBRARY.values()) <= set(_build.SOURCES)


def test_canvas_screenshot(tmp_path):
    jc, pc = _canvases(64, 96, n=500, seed=2)
    paths = [str(tmp_path / f"{tag}.png") for tag in ("port", "jax")]
    pc.screenshot(paths[0])
    jc.screenshot(paths[1])
    img = np.asarray(Image.open(paths[0]))
    assert img.shape == (64, 96, 3)
    np.testing.assert_array_equal(img, pc.draw())
    _close(img, np.asarray(Image.open(paths[1])), RGB_LEVELS)


@pytest.mark.parametrize("ext", [".ply", ".gsz", ".splat"])
def test_load_gaussians_hot_swap(ext, tmp_path):
    """load_gaussians reads .ply, .gsz and .splat files written by the JAX
    package onto the canvas's device, as the JAX Canvas loads them; a file
    that fails to load leaves the current scene in place."""
    path = str(tmp_path / f"scene{ext}")
    {".ply": save_ply, ".gsz": save_compact, ".splat": save_splat}[ext](
        jax_make_scene(123, seed=9), path)
    jc, pc = _canvases(48, 64, n=300)
    for c in (jc, pc):
        c.drop_file(path)
    assert pc._last_drop == path and pc.scene.num_gaussians == 123
    assert pc.scene.positions.device.type == "cpu"
    np.testing.assert_array_equal(pc.scene.positions.numpy(), np.asarray(jc.scene.positions))
    pc.render()
    jc.render()
    _close(pc.draw(), jc.draw(), RGB_LEVELS)
    bad = tmp_path / f"bad{ext}"
    bad.write_bytes(b"not a scene")
    with pytest.raises(Exception):
        pc.load_gaussians(str(bad))
    assert pc.scene.num_gaussians == 123


@pytest.mark.usefixtures("one_torch_thread")
def test_packed_canvas_matches_jax_packed():
    """The default compositor: the port's packed Canvas (the plain packed
    compositor on the CPU) against the JAX packed Canvas (its Pallas
    compositor in interpret mode), draw() within 1 level."""
    jc, pc = _canvases(64, 96, n=500, compositor="packed")
    pc.render()
    jc.render()
    _close(pc.draw(), jc.draw(), RGB_LEVELS)


def test_orbit_controls_and_timer():
    ours, theirs = OrbitControls(), JaxOrbitControls()
    for oc in (ours, theirs):
        assert oc.move(5, 5) is None
        oc.press(0, 0)
    assert ours.move(4, 8) == theirs.move(4, 8) == (4 * 0.25, 8 * 0.25)
    ours.release()
    assert ours.move(9, 9) is None
    t = FrameTimer(report_every=2)
    assert t.tick() is None
    line = None
    for _ in range(3):
        line = t.tick() or line
    assert line is not None and "ms/frame" in line


def test_render_without_scene_raises():
    with pytest.raises(RuntimeError, match="no scene"):
        Canvas(height=32, width=32, device="cpu").render()


def test_canvas_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the canvas runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        Canvas(height=32, width=32)


def test_canvas_keeps_the_scene_on_its_device():
    scene = gt.make_random_scene(50, seed=1, device="cpu")
    pc = Canvas(height=32, width=32, device="cpu")
    pc.set_scene(scene)
    assert all(x is y for x, y in zip(pc.scene, scene) if x is not None)
