"""The benchmark's plain reference against the port's CPU path at a tiny
size: frames, and a training step's loss, gradients and update. This
test imports both; the reference itself imports nothing of the port."""

import numpy as np
import pytest
import torch

import gaussianrenderer_tpu_torch as gt
from benchmark.reference import render as R
from benchmark.reference import train as RT
from benchmark.reference.scene_io import read_scene

W, H = 128, 96


def port_camera(pos, fov=60.0):
    cam = gt.Camera()
    cam.set_position(list(pos))
    cam.set_look_at([0.0, 0.0, 0.0])
    cam.set_fov_y(fov)
    cam.set_aspect_ratio(W / H)
    cam.set_clipping_planes(0.2, 100.0)
    cam.update_camera_matrices()
    return cam.params(3.0, device="cpu")


@pytest.mark.parametrize("sd", [1, 3])
def test_reader_matches_the_port_loader(tiny_scene, sd):
    mine = read_scene(tiny_scene, sd)
    scene = gt.load_scene(tiny_scene, max_sh_degree=sd, device="cpu")
    assert mine["sh"].shape[1] == 3 * (sd + 1) ** 2
    assert not mine["sh"][:, 12:].any()
    np.testing.assert_array_equal(mine["positions"], scene.positions.numpy())
    np.testing.assert_array_equal(mine["sh"], scene.sh.numpy())
    act = R.activate({k: torch.from_numpy(v) for k, v in mine.items()})
    torch.testing.assert_close(act["opacity"], scene.opacity, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(act["scales"], scene.scales, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("pos", [(3.0, 1.0, 3.0), (-3.5, 0.5, 1.0), (0.5, 3.0, -2.5)])
def test_frame_matches_the_port(tiny_scene, pos):
    scene = gt.load_scene(tiny_scene, max_sh_degree=1, device="cpu")
    cfg = gt.RenderConfig(width=W, height=H, sh_degree=1, compositor="packed")
    fb, _ = gt.render_frame(scene, port_camera(pos), cfg)
    ref_scene = R.activate({k: torch.from_numpy(v) for k, v in read_scene(tiny_scene, 1).items()})
    ref = R.render(ref_scene, R.look_at(pos, (0, 0, 0), 60.0, W / H, 0.2, 100.0),
                   R.Geometry(W, H, 32, 32), 1, round_centers=True)
    assert (fb - ref).abs().max() < 2e-2
    assert (fb - ref).pow(2).mean().sqrt() < 2e-3


@pytest.mark.parametrize("sd", [1, 3])
def test_training_step_matches_the_port(tiny_scene, sd):
    scene = gt.load_scene(tiny_scene, max_sh_degree=sd, device="cpu")
    params = gt.SceneParams.from_scene(scene)
    cfg = gt.RenderConfig(width=W, height=H, sh_degree=sd, compositor="diff")
    pos = (3.0, 1.0, 3.0)
    geo = R.Geometry(W, H, 32, 32)
    cam = R.look_at(pos, (0, 0, 0), 60.0, W / H, 0.2, 100.0)
    ref_params = {k: torch.from_numpy(v) for k, v in read_scene(tiny_scene, sd).items()}
    target = R.render(R.activate(ref_params), cam, geo, sd, round_centers=False)
    start = {k: v + 0.02 if k == "positions" else v for k, v in ref_params.items()}
    loss_r, grads_r = RT.loss_and_grads(start, cam, target, geo, sd)

    leaves = gt.SceneParams(*(None if p is None else p.detach().clone().requires_grad_(True)
                              for p in params._replace(positions=params.positions + 0.02)))
    loss_p = gt.l1_dssim_loss(leaves, port_camera(pos), target, cfg)
    live = [p for p in leaves if p is not None]
    grads_p = dict(zip(RT.LEAVES, torch.autograd.grad(loss_p, live)))
    assert float(loss_p.detach()) == pytest.approx(float(loss_r), rel=1e-4)
    for k in RT.LEAVES:
        a, b = grads_p[k], grads_r[k]
        assert float((a - b).norm()) <= 1e-3 * float(b.norm()) + 1e-9, k
