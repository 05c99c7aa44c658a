"""The port's Camera and CameraParams against the JAX package's, and the
convert module that carries JAX-side state across."""

import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.scene.camera import Camera as JaxCamera
from gaussianrenderer_tpu.scene.camera import perspective_matrix as jax_persp

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.convert import to_torch_camera, to_torch_scene
from gaussianrenderer_tpu_torch.scene.camera import perspective_matrix

from test_torch_common import both_scenes, np_tree

_MATRICES = ("view", "proj", "full_proj", "r_cam", "plane_normals",
             "position", "f_axis", "r_axis", "u_axis")


def _drive(cls, steps):
    cam = cls()
    for name, args in steps:
        getattr(cam, name)(*args)
    return cam


_POSES = [
    [],
    [("set_position", ([0.5, -0.4, 5.5],)), ("set_fov_y", (55.0,)),
     ("set_aspect_ratio", (1.25,)), ("set_clipping_planes", (0.2, 100.0)),
     ("update_camera_matrices", ()), ("update_frustum_planes", ())],
    [("set_position", ([-1.5, -1.5, -3.0],)), ("set_fov_y", (90.0,)),
     ("update_camera_matrices", ()), ("orbit", (30.0, -20.0)),
     ("zoom", (0.7,)), ("update_frustum_planes", ())],
    [("set_world_up", ([0.0, 0.0, 1.0],)), ("set_position", ([3.0, 2.0, 1.0],)),
     ("set_look_at", ([0.1, 0.2, 0.3],)), ("update_camera_matrices", ()),
     ("orbit", (-400.0, 170.0))],
]


@pytest.mark.parametrize("steps", _POSES)
def test_camera_state_matches(steps):
    j = _drive(JaxCamera, steps)
    p = _drive(gt.Camera, steps)
    for name in _MATRICES:
        np.testing.assert_array_equal(getattr(j, name), getattr(p, name), err_msg=name)
    for name in ("fov_y", "aspect", "near", "far"):
        assert getattr(j, name) == getattr(p, name)
    np.testing.assert_array_equal(
        j.transform_point_to_camera_space([0.3, 0.2, 0.1]),
        p.transform_point_to_camera_space([0.3, 0.2, 0.1]),
    )


@pytest.mark.parametrize("convention", ["opencv", "opengl"])
def test_from_pose_matches(convention):
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    c2w = np.concatenate([q, rng.normal(size=(3, 1))], 1).astype(np.float32)
    kw = dict(fy=500.0, height=480, aspect=1.5, convention=convention)
    j = JaxCamera.from_pose(c2w, **kw)
    p = gt.Camera.from_pose(c2w, **kw)
    for name in _MATRICES:
        np.testing.assert_array_equal(getattr(j, name), getattr(p, name))
    with pytest.raises(ValueError):
        gt.Camera.from_pose(np.eye(3), fov_y_deg=50.0)


def test_perspective_matrix_matches():
    np.testing.assert_array_equal(
        jax_persp(70.0, 16 / 9, 0.2, 100.0), perspective_matrix(70.0, 16 / 9, 0.2, 100.0)
    )


def test_params_match_jax_params():
    j = _drive(JaxCamera, _POSES[2])
    p = _drive(gt.Camera, _POSES[2])
    jp = np_tree(j.params(0.7))
    pp = p.params(0.7, device="cpu")
    assert pp._fields == jp._fields
    for name in jp._fields:
        got = getattr(pp, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(getattr(jp, name)), got.numpy())
    np.testing.assert_allclose(
        np.asarray(jp.proj @ jp.view), pp.full_proj.numpy(), rtol=1e-6, atol=1e-6
    )
    conv = to_torch_camera(jp, device="cpu")
    for name in jp._fields:
        torch.testing.assert_close(getattr(conv, name), getattr(pp, name), rtol=0, atol=0)


def test_convert_scene():
    js, ps = both_scenes(300, seed=4, spacetime=True)
    for f in js._fields:
        got = getattr(ps, f)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), got.numpy())
    # The port's own containers convert too (tensors pass through NumPy).
    again = to_torch_scene(ps, device="cpu")
    torch.testing.assert_close(again.sh, ps.sh, rtol=0, atol=0)
    static = to_torch_scene(js._replace(time_params=None), device="cpu")
    assert static.time_params is None and not static.is_spacetime
