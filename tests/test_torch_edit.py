"""The port's scene editing (``scene/edit.py``) and ``ops/sh.eval_sh``
against the JAX package's on the CPU.

Gates:
- ``eval_sh`` within 1e-6 of JAX's at degrees 0–3, clamped and not;
- the band rotation: the helpers (``_band_basis``, ``_fibonacci_dirs``,
  ``sh_band_rotation``, ``axis_angle_rotation``, ``_quat_mul``) equal to
  JAX's, and equivariance: the port's ``eval_sh`` of the rotated scene at
  R·d within 2e-5 of the original's at d (``tests/test_edit.py``'s gate);
- ``transform_scene`` (static degree 3; spacetime with 5 and 2 time
  columns), ``crop_scene``, ``prune_scene`` and ``merge_scenes`` (mixed
  degrees, static and spacetime) bit-equal to JAX's: both compute in the
  same float64 NumPy and round to float32 once, so no ulp differs;
- the transformed scene rendered from the transformed camera within
  40 dB of the original render (the port's plain packed compositor).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops.sh import eval_sh as jax_eval_sh
from gaussianrenderer_tpu.scene import edit as jedit
from gaussianrenderer_tpu.scene.io import make_random_scene as jax_make_scene

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.convert import to_torch_scene
from gaussianrenderer_tpu_torch.scene import edit

from test_torch_common import np_tree, one_torch_thread, psnr_np  # noqa: F401
from test_torch_compact import assert_scenes_equal

R_TEST = edit.axis_angle_rotation([0.3, 1.0, -0.5], 73.0)


def pair(n, seed, **kw):
    js = jax_make_scene(n, seed=seed, **kw)
    return js, to_torch_scene(np_tree(js), device="cpu")


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(0, 1, (257, 48)).astype(np.float32)
    dirs = rng.normal(size=(257, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    for clamp in (True, False):
        got = gt.eval_sh(torch.from_numpy(sh), torch.from_numpy(dirs), degree, clamp=clamp)
        want = np.asarray(jax_eval_sh(jnp.asarray(sh), jnp.asarray(dirs), degree, clamp=clamp))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # The degree is capped at the stored one.
    np.testing.assert_array_equal(
        gt.eval_sh(torch.from_numpy(sh[:, :12]), torch.from_numpy(dirs), 3).numpy(),
        gt.eval_sh(torch.from_numpy(sh[:, :12]), torch.from_numpy(dirs), 1).numpy())


def test_rotation_helpers_match_jax():
    for l in (1, 2, 3):
        dirs = edit._fibonacci_dirs(16 * (2 * l + 1))
        np.testing.assert_array_equal(dirs, jedit._fibonacci_dirs(16 * (2 * l + 1)))
        np.testing.assert_array_equal(edit._band_basis(dirs, l), jedit._band_basis(dirs, l))
        x = edit.sh_band_rotation(R_TEST, l)
        np.testing.assert_array_equal(x, jedit.sh_band_rotation(R_TEST, l))
        np.testing.assert_allclose(x @ x.T, np.eye(2 * l + 1), atol=1e-9)
        np.testing.assert_allclose(edit.sh_band_rotation(np.eye(3), l), np.eye(2 * l + 1),
                                   atol=1e-10)
    with pytest.raises(ValueError, match="band"):
        edit._band_basis(dirs, 4)
    np.testing.assert_array_equal(R_TEST, jedit.axis_angle_rotation([0.3, 1.0, -0.5], 73.0))
    q = np.random.default_rng(1).normal(size=(9, 4))
    np.testing.assert_array_equal(edit._quat_mul(q[0], q), jedit._quat_mul(q[0], q))
    with pytest.raises(ValueError, match="nonzero"):
        edit.axis_angle_rotation([0, 0, 0], 10.0)


def test_sh_rotation_equivariance():
    """eval_sh of the rotated scene at R·d equals the original's at d
    (unclamped, through degree 3)."""
    _, scene = pair(64, 1, sh_degree=3)
    rotated = edit.transform_scene(scene, rotation=R_TEST)
    rng = np.random.default_rng(7)
    dirs = rng.normal(size=(64, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ref = gt.eval_sh(scene.sh, torch.from_numpy(dirs.astype(np.float32)), 3, clamp=False)
    got = gt.eval_sh(rotated.sh, torch.from_numpy((dirs @ R_TEST.T).astype(np.float32)), 3,
                     clamp=False)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)


@pytest.mark.parametrize("time_cols", [0, 2, 5])
def test_transform_scene_matches_jax(time_cols):
    js, ps = pair(300, 3, sh_degree=3 if time_cols == 0 else 2, spacetime=time_cols > 0)
    if time_cols == 2:
        js = js._replace(time_params=js.time_params[:, :2])
        ps = ps._replace(time_params=ps.time_params[:, :2].contiguous())
    kw = dict(rotation=R_TEST, translation=[0.7, -4.0, 2.5], scale=1.6)
    got = edit.transform_scene(ps, **kw)
    assert_scenes_equal(got, jedit.transform_scene(js, **kw))
    assert_scenes_equal(edit.transform_scene(ps), jedit.transform_scene(js))
    got.opacity.add_(1.0)  # a new scene: the input's tensors are untouched
    assert float(ps.opacity.max()) <= 1.0


def test_transform_rejects_bad_inputs():
    _, scene = pair(8, 0)
    with pytest.raises(ValueError, match="rotation"):
        edit.transform_scene(scene, rotation=np.eye(3) * 2.0)
    with pytest.raises(ValueError, match="rotation"):
        edit.transform_scene(scene, rotation=np.diag([1.0, 1.0, -1.0]))
    with pytest.raises(ValueError, match="scale"):
        edit.transform_scene(scene, scale=-1.0)


def test_crop_prune_merge_match_jax():
    js, ps = pair(1200, 5, sh_degree=1)
    big = 1e9
    pparts, jparts = [], []
    for lo, hi in (([-big, -big, -big], [0.0, big, big]), ([0.0, -big, -big], [big, big, big])):
        pparts.append(edit.crop_scene(ps, lo, hi))
        jparts.append(jedit.crop_scene(js, lo, hi))
        assert_scenes_equal(pparts[-1], jparts[-1])
    assert sum(p.num_gaussians for p in pparts) == 1200
    assert_scenes_equal(edit.merge_scenes(*pparts), jedit.merge_scenes(*jparts))
    for kw in (dict(min_opacity=0.5), dict(max_scale=0.05), dict(min_opacity=0.3, max_scale=0.1)):
        assert_scenes_equal(edit.prune_scene(ps, **kw), jedit.prune_scene(js, **kw))


def test_merge_pads_sh_and_time_like_jax():
    ja, pa = pair(10, 0, sh_degree=0)
    jb, pb = pair(20, 1, sh_degree=2, spacetime=True)
    jc, pc = jb._replace(time_params=jb.time_params[:, :2]), pb._replace(
        time_params=pb.time_params[:, :2].contiguous())
    for pscenes, jscenes in (((pa, pb), (ja, jb)), ((pc, pb, pa), (jc, jb, ja)),
                             ((pa, pa), (ja, ja))):
        got = edit.merge_scenes(*pscenes)
        assert_scenes_equal(got, jedit.merge_scenes(*jscenes))
    m = edit.merge_scenes(pa, pb)
    assert (m.time_params[:10, 1] == edit.STATIC_T_SIGMA).all()
    with pytest.raises(ValueError, match="at least one"):
        edit.merge_scenes()


@pytest.mark.usefixtures("one_torch_thread")
def test_transformed_scene_matches_transformed_camera():
    _, scene = pair(1500, 3, sh_degree=2, scale_range=(0.03, 0.15))
    s, t = 1.6, np.array([0.7, -4.0, 2.5])
    moved = edit.transform_scene(scene, rotation=R_TEST, translation=t, scale=s)
    cfg = gt.RenderConfig(height=96, width=128)

    def render(sc, pos, look, up, near, far):
        cam = gt.Camera()
        cam.set_position(pos)
        cam.set_look_at(look)
        cam.set_world_up(up)
        cam.set_fov_y(60.0)
        cam.set_aspect_ratio(128 / 96)
        cam.set_clipping_planes(near, far)
        cam.update_camera_matrices()
        fb, _ = gt.render_frame(sc, cam.params(cfg.k_sigma, device="cpu"), cfg)
        return fb.numpy()

    pos, look, up = np.array([0.5, 0.8, 5.5]), np.zeros(3), np.array([0.0, 1.0, 0.0])
    ref = render(scene, pos, look, up, 0.2, 100.0)
    got = render(moved, s * (R_TEST @ pos) + t, s * (R_TEST @ look) + t, R_TEST @ up,
                 0.2 * s, 100.0 * s)
    score = psnr_np(ref, got)
    assert score > 40.0, f"transformed render PSNR {score:.1f} dB"
