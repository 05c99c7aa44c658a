"""Datasets, evaluation, checkpoints and PLY output of the port
(``load_views``, ``dataset_image_shape``, ``evaluate``,
``save_checkpoint``/``load_checkpoint``, ``scene.io.save_ply``) against the
JAX package's on the CPU.

Gates: ``load_views`` on a ``poses.json`` dataset with ``.npy`` float,
``.npy`` uint8 and ``.png`` targets, strides and a timed record: every
camera field within 1e-6 absolute and targets bit-equal;
``dataset_image_shape`` equal; ``evaluate`` PSNR within 1e-4 dB and SSIM
within 1e-5 of JAX's (the scan compositor on both sides); checkpoints
restore bit for bit; ``save_ply`` files byte-equal to JAX's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaussianrenderer_tpu import train as jtrain
from gaussianrenderer_tpu.scene.io import make_random_scene as jax_make_scene
from gaussianrenderer_tpu.scene.io import save_ply as jax_save_ply

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.convert import to_torch_params, to_torch_scene

from test_torch_common import both_cameras, jax_camera, np_tree, one_torch_thread  # noqa: F401
from test_torch_train import train_setup

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W = 64, 128


def c2w_of(cam):
    m = np.zeros((3, 4), np.float32)
    m[:, 0], m[:, 1], m[:, 2] = cam.r_axis, -cam.u_axis, -cam.f_axis
    m[:, 3] = cam.position
    return m


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Four records: float .npy, uint8 .npy, a PNG with a time, a float
    .npy with an opengl pose and fy instead of fov_y."""
    root = tmp_path_factory.mktemp("poses")
    rng = np.random.default_rng(5)
    records = []
    for i in range(4):
        cam = jax_camera(W, H, pos=(0.5 * i - 0.7, 0.3, 5.0), fov=60.0)
        rec = {"c2w": c2w_of(cam).tolist(), "fov_y": 60.0, "near": 0.2, "far": 50.0}
        img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        if i == 0:
            np.save(root / "t0.npy", img)
            rec["target"] = "t0.npy"
        elif i == 1:
            np.save(root / "t1.npy", (img * 255).astype(np.uint8))
            rec["target"] = "t1.npy"
        elif i == 2:
            Image.fromarray((img * 255).astype(np.uint8)).save(root / "t2.png")
            rec.update(target="t2.png", time=0.7)
        else:
            m = c2w_of(cam)
            m[:, 1:3] *= -1.0  # opencv → opengl axes
            rec.update(c2w=np.concatenate([m, [[0, 0, 0, 1]]]).tolist(), target="t3.npy",
                       convention="opengl", fy=H / (2 * np.tan(np.radians(30.0))))
            del rec["fov_y"]
            np.save(root / "t3.npy", np.concatenate([img, img[..., :1]], axis=2))
        records.append(rec)
    (root / "poses.json").write_text(json.dumps(records))
    return str(root)


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_load_views_matches_jax(dataset, stride):
    (_, jcfg, _), (_, pcfg, _), _ = train_setup()
    jviews = jtrain.load_views(dataset, jcfg, stride=stride)
    pviews = gt.load_views(dataset, pcfg, stride=stride, device="cpu")
    assert len(pviews) == len(jviews) == len(range(0, 4, stride))
    for jv, pv in zip(jviews, pviews):
        assert len(pv) == len(jv)
        for f in gt.CameraParams._fields:
            np.testing.assert_allclose(getattr(pv[0], f).numpy(),
                                       np.asarray(getattr(jv[0], f)), rtol=0, atol=1e-6,
                                       err_msg=f)
        assert pv[1].dtype == torch.float32 and pv[1].shape == (3, H, W)
        np.testing.assert_array_equal(pv[1].numpy(), np.asarray(jv[1]))
        if len(jv) == 3:
            assert pv[2] == jv[2] == 0.7
    assert gt.dataset_image_shape(dataset) == jtrain.dataset_image_shape(dataset) == (H, W)


def test_load_views_rejects(dataset, tmp_path):
    with pytest.raises(ValueError, match=r"expected \(32, 128, 3\)"):
        gt.load_views(dataset, gt.RenderConfig(height=32, width=W), device="cpu")
    with pytest.raises(ValueError, match="split="):
        gt.load_views(dataset, gt.RenderConfig(height=H, width=W), split="test",
                      device="cpu")
    # A directory with no poses.json, no reconstruction (an empty sparse/0)
    # and no transforms file: both packages look for poses.json.
    (tmp_path / "sparse" / "0").mkdir(parents=True)
    for fn in (lambda: gt.dataset_image_shape(str(tmp_path)),
               lambda: gt.load_views(str(tmp_path), gt.RenderConfig(), device="cpu"),
               lambda: jtrain.dataset_image_shape(str(tmp_path)),
               lambda: jtrain.load_views(str(tmp_path), jtrain.RenderConfig())):
        with pytest.raises(FileNotFoundError, match="poses.json"):
            fn()


def test_evaluate_matches_jax():
    (jp, jcfg, jcam), (pp, pcfg, pcam), _ = train_setup()
    j2, p2, _ = both_cameras(W, H, pos=(1.0, 0.5, 5.0), fov=60.0)
    rng = np.random.default_rng(3)
    noise = rng.normal(size=np.asarray(jp.sh).shape).astype(np.float32)
    jworse = jp._replace(sh=jp.sh + 0.3 * jnp.asarray(noise))
    pworse = pp._replace(sh=pp.sh + 0.3 * torch.from_numpy(noise))
    jviews = [(c, jtrain.render_for_training(jp, c, jcfg)) for c in (jcam, j2)]
    pviews = [(c, torch.from_numpy(np.array(t))) for c, (_, t) in zip((pcam, p2), jviews)]
    want = jtrain.evaluate(jworse, jviews, jcfg)
    seen = []
    got = gt.evaluate(pworse, pviews, pcfg,
                      per_view_fn=lambda i, fb, t, row: seen.append((i, fb.shape, row)))
    assert len(got["per_view"]) == 2 and [s[0] for s in seen] == [0, 1]
    assert seen[0][1] == (3, H, W) and seen[1][2] is got["per_view"][1]
    for g, w in zip(got["per_view"] + [got], want["per_view"] + [want]):
        assert abs(g["psnr"] - w["psnr"]) <= 1e-4, (g, w)
        assert abs(g["ssim"] - w["ssim"]) <= 1e-5, (g, w)
    assert 10.0 < got["psnr"] < 60.0
    # The generating params score near-lossless; render_fn replaces the render.
    perfect = gt.evaluate(pp, pviews[:1], pcfg)
    assert perfect["psnr"] > 80.0 and perfect["ssim"] > 0.999
    other = gt.evaluate(None, pviews[:1], pcfg, render_fn=lambda cam, tv: pviews[0][1])
    assert other["psnr"] == 120.0 and other["ssim"] == pytest.approx(1.0, abs=1e-6)
    with pytest.raises(ValueError, match="no views"):
        gt.evaluate(pp, [], pcfg)


def _state(n=64, seed=0):
    scene = to_torch_scene(np_tree(jax_make_scene(n, seed=seed, spacetime=True)), "cpu")
    params = gt.SceneParams.from_scene(scene)
    opt = gt.make_3dgs_optimizer()
    grads = gt.SceneParams(*(torch.ones_like(p) for p in params))
    _, opt_state = opt.update(grads, opt.init(params), params)
    dstate = gt.DensifyState.zero(n, device="cpu")._replace(
        steps=torch.tensor(5, dtype=torch.int32), grad_accum=torch.rand(n))
    return params, opt_state, dstate, opt


def test_checkpoint_roundtrip(tmp_path):
    params, opt_state, dstate, opt = _state()
    path = str(tmp_path / "step_000042")
    gt.save_checkpoint(path, params, opt_state, dstate, step=42)
    fresh, _, _, _ = _state(seed=99)
    rp, ro, rd, step = gt.load_checkpoint(path, fresh, opt.init(fresh),
                                          gt.DensifyState.zero(64, device="cpu"))
    assert step == 42 and isinstance(ro, type(opt_state)) and isinstance(rd, gt.DensifyState)
    for f in gt.SceneParams._fields:
        assert torch.equal(getattr(rp, f), getattr(params, f)), f
        assert torch.equal(getattr(ro.mu, f), getattr(opt_state.mu, f)), f
        assert torch.equal(getattr(ro.nu, f), getattr(opt_state.nu, f)), f
    assert int(ro.count) == 1 and ro.count.dtype == torch.int32
    for a, b in zip(rd, dstate):
        assert torch.equal(a, b)
    assert rp.positions.device == fresh.positions.device


def test_checkpoint_partial_restore_and_errors(tmp_path):
    params, opt_state, dstate, _ = _state()
    path = str(tmp_path / "ckpt")
    gt.save_checkpoint(path, params, opt_state, dstate, step=9)
    fresh, _, _, _ = _state(seed=98)
    rp, ro, rd, step = gt.load_checkpoint(path, fresh)
    assert step == 9 and ro is None and rd is None
    assert torch.equal(rp.positions, params.positions)
    path2 = str(tmp_path / "ckpt2")
    gt.save_checkpoint(path2, params, step=1)
    with pytest.raises(ValueError, match="densify"):
        gt.load_checkpoint(path2, fresh, None, gt.DensifyState.zero(64, device="cpu"))
    small, _, _, _ = _state(n=32)
    with pytest.raises(ValueError, match="shape"):
        gt.load_checkpoint(path, small)


@pytest.mark.parametrize("time_cols", [0, 2, 5])
def test_save_ply_byte_equal_to_jax(tmp_path, time_cols):
    js = jax_make_scene(200, seed=4, spacetime=time_cols > 0, sh_degree=1)
    if time_cols == 2:
        js = js._replace(time_params=js.time_params[:, :2])
    ps = to_torch_scene(np_tree(js), "cpu")
    jax_save_ply(js, str(tmp_path / "jax.ply"))
    gt.save_ply(ps, str(tmp_path / "port.ply"))
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    back = gt.load_ply(str(tmp_path / "port.ply"), max_sh_degree=1, device="cpu")
    assert back.num_gaussians == 200
    np.testing.assert_array_equal(back.positions.numpy(), ps.positions.numpy())
    np.testing.assert_allclose(back.opacity.numpy(), ps.opacity.numpy(), rtol=1e-5)
    np.testing.assert_allclose(back.scales.numpy(), ps.scales.numpy(), rtol=1e-5)
    if time_cols:
        np.testing.assert_array_equal(back.time_params.numpy(), ps.time_params.numpy())
    else:
        assert back.time_params is None
    # A trained params container writes the same file as its scene.
    gt.save_ply(to_torch_params(np_tree(jtrain.SceneParams.from_scene(js)), "cpu").to_scene(),
                str(tmp_path / "params.ply"))
    assert gt.load_ply(str(tmp_path / "params.ply"), max_sh_degree=1,
                       device="cpu").num_gaussians == 200
