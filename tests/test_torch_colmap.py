"""The port's COLMAP ingestion and export (``scene/colmap.py``) and the
COLMAP branches of ``train.load_views``/``dataset_image_shape`` against
the JAX package's on the CPU.

Gates:
- the readers give equal cameras, images and points (the JAX package's
  Python loop for points3D.bin, which its C++ reader matches);
- the writers and ``save_colmap_workspace`` write byte-equal files;
- ``rotmat2qvec``, ``camera_w2c``, ``pose_to_c2w`` equal;
- ``load_colmap``/``load_views``: every camera field and every target
  bit-equal, at the capture size, resized same-aspect (PIL LANCZOS),
  strided and limited; the aspect guard and ``split=`` raise alike;
- ``init_from_points`` (subsample, jitter upsample, one point) bit-equal;
- four ``fit_scene`` steps from the SfM start on COLMAP views: every
  loss within 1e-4 relative of JAX's.
"""

import os
import struct

import numpy as np
import pytest
import torch

from gaussianrenderer_tpu import train as jtrain
from gaussianrenderer_tpu.config import RenderConfig as JaxConfig
from gaussianrenderer_tpu.scene import colmap as jcolmap
from gaussianrenderer_tpu.scene.camera import Camera as JaxCamera

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.scene import colmap

from test_colmap import _rotmat, write_colmap_workspace
from test_torch_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def assert_views_equal(pviews, jviews):
    """Every camera field and target bit-equal, and the same times."""
    assert len(pviews) == len(jviews) > 0
    for pv, jv in zip(pviews, jviews):
        assert len(pv) == len(jv)
        for f in gt.CameraParams._fields:
            np.testing.assert_array_equal(getattr(pv[0], f).numpy(),
                                          np.asarray(getattr(jv[0], f)), err_msg=f)
        assert pv[1].dtype == torch.float32 and pv[1].is_contiguous()
        np.testing.assert_array_equal(pv[1].numpy(), np.asarray(jv[1]))
        if len(jv) == 3:
            assert pv[2] == jv[2]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """tests/test_colmap.py's workspace: 3 posed 64×48 images (tracks of 2
    points each) and 3 points with tracks."""
    root = str(tmp_path_factory.mktemp("colmap"))
    poses = []
    for i in range(3):
        r = _rotmat([0.2, 1.0, 0.1 * i], 0.4 * i + 0.1)
        poses.append((r, np.array([0.1 * i, -0.2, 3.0 + i])))
    pts = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, -1.0], [-2.0, 0.5, 1.0]])
    cols = np.array([[255, 0, 0], [0, 128, 0], [10, 20, 250]], np.uint8)
    write_colmap_workspace(root, poses, points=pts, colors=cols)
    return root


def test_readers_match_jax(workspace):
    sparse = colmap.find_sparse_dir(workspace)
    assert sparse == jcolmap.find_sparse_dir(workspace)
    assert colmap.is_colmap_dir(workspace) and not colmap.is_colmap_dir(sparse + "/..")
    pc = colmap.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    jc = jcolmap.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    assert pc.keys() == jc.keys()
    for k in jc:
        assert (pc[k].model, pc[k].width, pc[k].height, pc[k].fy, pc[k].fov_y_deg) == (
            jc[k].model, jc[k].width, jc[k].height, jc[k].fy, jc[k].fov_y_deg)
        np.testing.assert_array_equal(pc[k].params, jc[k].params)
    pi = colmap.read_images_bin(os.path.join(sparse, "images.bin"))
    ji = jcolmap.read_images_bin(os.path.join(sparse, "images.bin"))
    assert pi.keys() == ji.keys()
    for k in ji:
        assert (pi[k].camera_id, pi[k].name) == (ji[k].camera_id, ji[k].name)
        for a, b in ((pi[k].qvec, ji[k].qvec), (pi[k].tvec, ji[k].tvec),
                     (colmap.qvec2rotmat(pi[k].qvec), jcolmap.qvec2rotmat(ji[k].qvec)),
                     (colmap.pose_to_c2w(pi[k].qvec, pi[k].tvec),
                      jcolmap.pose_to_c2w(ji[k].qvec, ji[k].tvec))):
            np.testing.assert_array_equal(a, b)
    path = os.path.join(sparse, "points3D.bin")
    for use_native in (True, False):
        for a, b in zip(colmap.read_points3d_bin(path, use_native=use_native),
                        jcolmap.read_points3d_bin(path, use_native=use_native)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for a, b in zip(colmap.load_colmap_points(workspace), jcolmap.load_colmap_points(workspace)):
        np.testing.assert_array_equal(a, b)


def test_points_reader_variable_tracks_and_truncation(tmp_path):
    """tests/test_colmap.py's variable-track file: the port's native
    reader equals the JAX package's native reader and its loop the JAX
    package's loop, and a truncated file raises on both paths."""
    rng = np.random.default_rng(5)
    n = 200
    path = str(tmp_path / "points3D.bin")
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", n))
        for j in range(n):
            fh.write(struct.pack("<Q", j * 7 + 1))
            fh.write(struct.pack("<ddd", *rng.normal(0, 10, 3)))
            fh.write(struct.pack("<BBB", *rng.integers(0, 256, 3)))
            fh.write(struct.pack("<d", rng.uniform(0, 2)))
            track = int(rng.integers(0, 9))
            fh.write(struct.pack("<Q", track))
            fh.write(struct.pack("<ii", 1, 0) * track)
    for use_native in (False, True):
        for a, b in zip(colmap.read_points3d_bin(path, use_native=use_native),
                        jcolmap.read_points3d_bin(path, use_native=use_native)):
            np.testing.assert_array_equal(a, b)
    with open(path, "rb") as fh:
        data = fh.read()
    trunc = str(tmp_path / "trunc.bin")
    with open(trunc, "wb") as fh:
        fh.write(data[: len(data) - 9])
    for use_native in (True, False):
        with pytest.raises(ValueError, match="truncated"):
            colmap.read_points3d_bin(trunc, use_native=use_native)


def test_rotations_match_jax():
    rng = np.random.default_rng(7)
    for i in range(20):
        r = _rotmat(rng.normal(size=3), np.pi * i / 19.0)  # both branches, w ≈ 0
        np.testing.assert_array_equal(colmap.rotmat2qvec(r), jcolmap.rotmat2qvec(r))
    for pos, look in (([2.0, 1.5, -3.0], [0.0, 0.0, 0.0]), ([-1.0, 4.0, 2.0], [0.5, -0.5, 0.0])):
        cams = []
        for cls in (gt.Camera, JaxCamera):
            cam = cls()
            cam.set_position(pos)
            cam.set_look_at(look)
            cam.update_camera_matrices()
            cams.append(cam)
        for a, b in zip(colmap.camera_w2c(cams[0]), jcolmap.camera_w2c(cams[1])):
            np.testing.assert_array_equal(a, b)


def _camera_pair(i, w=64, h=48):
    out = []
    for cls in (gt.Camera, JaxCamera):
        cam = cls()
        ang = 2 * np.pi * i / 3
        cam.set_position([3 * np.sin(ang), 1.0, 3 * np.cos(ang)])
        cam.set_look_at([0, 0, 0])
        cam.set_fov_y(60.0)
        cam.set_aspect_ratio(w / h)
        cam.update_camera_matrices()
        out.append(cam)
    return out


def test_writers_byte_equal_to_jax(tmp_path):
    cams = {1: (np.array([60.0, 61.0, 32.0, 24.0]), "PINHOLE", 64, 48),
            3: (np.array([40.0, 16.0, 16.0]), "SIMPLE_PINHOLE", 32, 32)}
    r = _rotmat([0.3, 1.0, -0.2], 0.7)
    images = {5: (colmap.rotmat2qvec(r), np.array([0.1, 0.2, 0.3]), 1, "a.png"),
              2: (np.array([1.0, 0.0, 0.0, 0.0]), np.zeros(3), 3, "b/ü.png")}
    rng = np.random.default_rng(2)
    xyz, rgb01 = rng.normal(0, 1, (40, 3)), rng.uniform(0, 1, (40, 3))
    for tag, mod in (("port", colmap), ("jax", jcolmap)):
        d = tmp_path / tag
        d.mkdir()
        mod.write_cameras_bin(str(d / "cameras.bin"), {
            k: mod.ColmapCamera(m, w, h, p) for k, (p, m, w, h) in cams.items()})
        mod.write_images_bin(str(d / "images.bin"), {
            k: mod.ColmapImage(*v) for k, v in images.items()})
        mod.write_points3d_bin(str(d / "p_float.bin"), xyz, rgb01)
        mod.write_points3d_bin(str(d / "p_u8.bin"), xyz,
                               np.full((40, 3), 7, np.uint8), error=np.arange(40.0))
    for name in ("cameras.bin", "images.bin", "p_float.bin", "p_u8.bin"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    with pytest.raises(ValueError, match="takes 4 params"):
        colmap.write_cameras_bin(str(tmp_path / "x.bin"),
                                 {1: colmap.ColmapCamera("PINHOLE", 4, 4, np.ones(3))})


def test_save_colmap_workspace_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(11)
    pairs = [_camera_pair(i) for i in range(3)]
    frames = [(rng.uniform(0, 1, (48, 64, 3)) * 255).astype(np.uint8) for _ in range(2)]
    frames.append(rng.uniform(0, 1, (48, 64, 3)).astype(np.float32))  # floats in [0, 1]
    pts = rng.normal(0, 1, (10, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (10, 3))
    proot = colmap.save_colmap_workspace(str(tmp_path / "port"), [p for p, _ in pairs], frames,
                                         points_xyz=pts, points_rgb=cols)
    jroot = jcolmap.save_colmap_workspace(str(tmp_path / "jax"), [j for _, j in pairs], frames,
                                          points_xyz=pts, points_rgb=cols)
    files = sorted(os.path.relpath(os.path.join(d, f), proot)
                   for d, _, fs in os.walk(proot) for f in fs)
    assert len(files) == 6
    for rel in files:
        with open(os.path.join(proot, rel), "rb") as a, open(os.path.join(jroot, rel), "rb") as b:
            assert a.read() == b.read(), rel
    # Without points3D.bin, and with names given.
    colmap.save_colmap_workspace(str(tmp_path / "nopts"), [pairs[0][0]], frames[:1],
                                 names=["x.png"])
    assert sorted(os.listdir(tmp_path / "nopts" / "sparse" / "0")) == ["cameras.bin",
                                                                       "images.bin"]
    assert os.listdir(tmp_path / "nopts" / "images") == ["x.png"]
    with pytest.raises(ValueError, match="mismatch"):
        colmap.save_colmap_workspace(str(tmp_path / "bad"), [pairs[0][0]], frames)


@pytest.mark.parametrize("size,stride,limit", [
    ((48, 64), 1, None), ((24, 32), 1, None), ((36, 48), 2, None), ((48, 64), 1, 2),
])
def test_load_colmap_matches_jax(workspace, size, stride, limit):
    """At the capture size, downscaled (LANCZOS, same aspect), strided
    and limited, through load_colmap; through load_views too."""
    h, w = size
    pviews = colmap.load_colmap(workspace, gt.RenderConfig(height=h, width=w), stride=stride,
                                limit=limit, near=0.2, device="cpu")
    jviews = jcolmap.load_colmap(workspace, JaxConfig(height=h, width=w), stride=stride,
                                 limit=limit, near=0.2)
    assert len(pviews) == (2 if stride == 2 or limit else 3)
    assert_views_equal(pviews, jviews)
    if limit is None:
        assert_views_equal(
            gt.load_views(workspace, gt.RenderConfig(height=h, width=w), stride=stride,
                          device="cpu"),
            jtrain.load_views(workspace, JaxConfig(height=h, width=w), stride=stride))


def test_colmap_shape_and_rejections(workspace, tmp_path):
    assert gt.dataset_image_shape(workspace) == jtrain.dataset_image_shape(workspace) == (48, 64)
    with pytest.raises(ValueError, match="aspect"):
        gt.load_views(workspace, gt.RenderConfig(height=64, width=64), device="cpu")
    with pytest.raises(ValueError, match="llffhold"):
        gt.load_views(workspace, gt.RenderConfig(height=48, width=64), split="test",
                      device="cpu")
    # The reconstruction in sparse/ (no 0/) and a separate image root.
    alt = tmp_path / "alt"
    (alt / "sparse").mkdir(parents=True)
    for name in ("cameras.bin", "images.bin"):
        (alt / "sparse" / name).write_bytes(
            open(os.path.join(workspace, "sparse", "0", name), "rb").read())
    assert colmap.find_sparse_dir(str(alt)) == str(alt / "sparse")
    assert_views_equal(
        colmap.load_colmap(str(alt), gt.RenderConfig(height=48, width=64),
                           image_dir=os.path.join(workspace, "images"), device="cpu"),
        jcolmap.load_colmap(str(alt), JaxConfig(height=48, width=64),
                            image_dir=os.path.join(workspace, "images")))
    with pytest.raises(FileNotFoundError, match="cameras.bin"):
        colmap.find_sparse_dir(str(tmp_path / "empty"))


@pytest.mark.parametrize("m,n,deg", [(50, 30, 1), (50, 200, 0), (50, None, 2), (1, 1, 1)])
def test_init_from_points_matches_jax(m, n, deg):
    rng = np.random.default_rng(m + (n or 0))
    xyz = rng.normal(0, 1, (m, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    got = colmap.init_from_points(xyz, rgb, n=n, sh_degree=deg, seed=3, device="cpu")
    want = jcolmap.init_from_points(xyz, rgb, n=n, sh_degree=deg, seed=3)
    assert got.time_params is None
    for f in ("positions", "sh", "raw_opacity", "raw_scales", "quats"):
        p = getattr(got, f)
        assert p.dtype == torch.float32, f
        np.testing.assert_array_equal(p.numpy(), np.asarray(getattr(want, f)), err_msg=f)
    with pytest.raises(ValueError, match="empty"):
        colmap.init_from_points(np.zeros((0, 3)), np.zeros((0, 3)), device="cpu")


def test_fit_scene_on_colmap_views_matches_jax(workspace):
    """Four steps from the SfM start (the JAX package's own fit test on
    COLMAP views, 64 splats at SH degree 1, no densification)."""
    kw = dict(height=48, width=64, compositor="diff", sh_degree=1)
    jcfg = JaxConfig(diff_max_chunks=2, min_instance_capacity=1024, **kw)
    pcfg = gt.RenderConfig(diff_max_chunks=2, **kw)
    xyz, rgb = colmap.load_colmap_points(workspace)
    start = jcolmap.init_from_points(xyz, rgb, n=64, sh_degree=1, seed=0)
    _, jh = jtrain.fit_scene(jtrain.load_views(workspace, jcfg), jcfg, start, steps=4,
                             densify_every=0, auto_capacity=False)
    _, ph = gt.fit_scene(gt.load_views(workspace, pcfg, device="cpu"), pcfg,
                         colmap.init_from_points(xyz, rgb, n=64, sh_degree=1, seed=0,
                                                 device="cpu"),
                         steps=4, densify_every=0)
    assert len(ph["losses"]) == 4 and np.isfinite(ph["losses"]).all()
    np.testing.assert_allclose(ph["losses"], jh["losses"], rtol=1e-4, atol=0)
