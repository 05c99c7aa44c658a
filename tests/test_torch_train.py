"""Training's differentiable render and losses (``gaussianrenderer_tpu_torch.train``)
against the JAX package's ``train`` module on the CPU.

The port renders through the training compositor (its plain versions
here) or the scan compositor; the JAX side through its scan compositor
(``diff_kernel=False``), jitted. Gates: the gradient of ``mse_loss`` and
of ``l1_dssim_loss`` with respect to every leaf within 1e-3 of the
leaf's largest JAX gradient (measured ~3e-5: float order in the
compositor, the jitted projection's fused multiply-adds); the
``ndc_probe`` gradient likewise; the rendered frame within 1e-3 and
≥ 60 dB; SSIM within 1e-6. On a scene with splats behind the camera, off
screen and culled, every gradient is finite, the culled splats' are
exactly zero, and all are within 1e-3 of the JAX gradient through the
plain gather (XLA's scatter-add transpose): there one splat next to the
near plane dominates every column, and the JAX training path's segment
transpose, which differences f32 prefix sums, is itself 1.5e-2 off the
exact transpose in the quaternion column (the port's ``index_add_`` sums
each splat's rows directly).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu import train as jtrain
from gaussianrenderer_tpu.config import RenderConfig as JaxConfig
from gaussianrenderer_tpu.ops.compositing import (
    build_features as jax_build_features,
    composite_tiles_diff as jax_diff,
    gather_sorted_features as jax_gather,
)
from gaussianrenderer_tpu.ops.projection import preprocess_gaussians as jax_preprocess
from gaussianrenderer_tpu.ops.tiling import build_sorted_instances as jax_build_sorted

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.convert import to_torch_params

from test_torch_common import both_cameras, both_scenes, np_tree, psnr_np, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LEAVES = ("positions", "sh", "raw_opacity", "raw_scales", "quats")
GRAD_TOL = 1e-3


def train_setup(n=120, seed=2, extent=2.0, h=64, w=128):
    """The JAX package's training test setup (tests/test_train.py
    ``_setup``: 32×8 tiles, 8 chunks) in both packages, with a seeded
    uniform target."""
    js, ps = both_scenes(n, seed=seed, extent=extent, scale_range=(0.05, 0.2))
    kw = dict(height=h, width=w, compositor="xla", diff_max_chunks=8, num_tile_x=4,
              num_tile_y=8, diff_kernel=False)
    jcam, pcam, _ = both_cameras(w, h, pos=(0.0, 0.0, 5.0), fov=60.0)
    jp = jtrain.SceneParams.from_scene(js)
    target = np.random.default_rng(seed).uniform(0, 1, (3, h, w)).astype(np.float32)
    return (jp, JaxConfig(**kw), jcam), (to_torch_params(np_tree(jp), "cpu"),
                                         gt.RenderConfig(**kw), pcam), target


def jax_mse_plain_gather(params, cam, target, cfg):
    """The JAX package's training render and MSE, assembled from its
    public functions with the plain feature gather."""
    proj = jax_preprocess(
        params.to_scene(), cam, width=cfg.width, height=cfg.height,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h, tiles_x=cfg.tiles_x,
        tiles_y=cfg.tiles_y, sh_degree=cfg.sh_degree, quantize_centers=False,
    )
    n = params.positions.shape[0]
    asg = jax_build_sorted(proj, tiles_x=cfg.tiles_x, num_tiles=cfg.num_tiles,
                           capacity=cfg.instance_capacity(n), near=cam.near,
                           far=cam.far)
    fb = jax_diff(
        jax_gather(jax_build_features(proj), asg, cfg.chunk_size), asg.tile_start,
        asg.tile_count, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, width=cfg.width, height=cfg.height,
        chunk_size=cfg.chunk_size, max_chunks=cfg.diff_max_chunks,
    )
    return jnp.mean((fb - target) ** 2)


def port_grads(loss_fn, params, cam, target, cfg, **kw):
    leaves = gt.SceneParams(*(
        None if p is None else p.clone().requires_grad_(True) for p in params
    ))
    loss = loss_fn(leaves, cam, torch.from_numpy(target), cfg, **kw)
    loss.backward()
    return float(loss.detach()), leaves


def test_scene_params_roundtrip():
    (jp, _, _), (pp, _, _), _ = train_setup()
    np.testing.assert_array_equal(np.asarray(jp.raw_scales), pp.raw_scales.numpy())
    np.testing.assert_allclose(np.asarray(jp.raw_opacity), pp.raw_opacity.numpy(),
                               rtol=0, atol=2e-6)
    js, pp_back = jp.to_scene(), pp.to_scene()
    for f in ("opacity", "scales", "positions", "sh", "quats"):
        np.testing.assert_allclose(np.asarray(getattr(js, f)),
                                   getattr(pp_back, f).numpy(), rtol=1e-6, atol=1e-7)
    again = gt.SceneParams.from_scene(pp_back)
    np.testing.assert_allclose(again.raw_opacity.numpy(), pp.raw_opacity.numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("loss", ["mse_loss", "l1_dssim_loss"])
def test_loss_gradients_match_jax(loss):
    (jp, jcfg, jcam), (pp, pcfg, pcam), target = train_setup()
    jl, pl = getattr(jtrain, loss), getattr(gt, loss)
    jloss, jg = jax.jit(jax.value_and_grad(jl), static_argnums=(3,))(
        jp, jcam, jnp.asarray(target), jcfg)
    for kernel in (True, False):
        ploss, pg = port_grads(pl, pp, pcam, target,
                               dataclasses.replace(pcfg, diff_kernel=kernel))
        assert abs(ploss - float(jloss)) <= 1e-5 * abs(float(jloss))
        for f in LEAVES:
            a, b = getattr(pg, f).grad.numpy(), np.asarray(getattr(jg, f))
            assert np.abs(b).max() > 0, f
            rel = np.abs(a - b).max() / np.abs(b).max()
            assert rel <= GRAD_TOL, (loss, kernel, f, rel)


def test_render_for_training_and_ndc_probe_match_jax():
    (jp, jcfg, jcam), (pp, pcfg, pcam), target = train_setup()
    jfb = np.asarray(jtrain.render_for_training(jp, jcam, jcfg))
    pfb = gt.render_for_training(pp, pcam, pcfg)
    assert pfb.shape == (3, 64, 128)
    assert np.abs(pfb.numpy() - jfb).max() <= 1e-3 and psnr_np(pfb.numpy(), jfb) >= 60.0

    n = pp.positions.shape[0]
    jprobe = jax.jit(jax.grad(
        lambda pr: jtrain.mse_loss(jp, jcam, jnp.asarray(target), jcfg, ndc_probe=pr)
    ))(jnp.zeros((2, n), jnp.float32))
    probe = torch.zeros((2, n), requires_grad=True)
    gt.mse_loss(pp, pcam, torch.from_numpy(target), pcfg, ndc_probe=probe).backward()
    want = np.asarray(jprobe)
    assert np.abs(want).max() > 0
    assert np.abs(probe.grad.numpy() - want).max() <= GRAD_TOL * np.abs(want).max()


def nonfinite_rows(jp):
    """Rows 0–4 made unusable, as trained files can hold them
    (data/trained_500k.ply has three NaN splats): NaN position, inf
    scale, NaN SH, zero quaternion, a splat at the camera position."""
    pos, sh = np.array(jp.positions), np.array(jp.sh)
    raw_scales, quats = np.array(jp.raw_scales), np.array(jp.quats)
    pos[0] = np.nan
    raw_scales[1] = np.inf
    sh[2] = np.nan
    quats[3] = 0.0
    pos[4] = [0.0, 0.0, 5.0]
    return jp._replace(positions=jnp.asarray(pos), sh=jnp.asarray(sh),
                       raw_scales=jnp.asarray(raw_scales), quats=jnp.asarray(quats))


def round_on_axis(jp):
    """Row 5 becomes a sphere at the origin, on the optical axis: its
    screen ellipse is an exact circle (the 2:1 frame's pixel scales are
    powers of two apart), so the AABB's eigen-extent is √0 and atan2 is at
    (0, 0): infinite local derivatives on the AABB path."""
    pos, raw_scales = np.array(jp.positions), np.array(jp.raw_scales)
    quats = np.array(jp.quats)
    pos[5] = 0.0
    raw_scales[5] = np.log(0.1)
    quats[5] = [1.0, 0.0, 0.0, 0.0]
    return jp._replace(positions=jnp.asarray(pos), raw_scales=jnp.asarray(raw_scales),
                       quats=jnp.asarray(quats))


@pytest.mark.parametrize("case", ["culled", "nonfinite"])
def test_gradients_finite_with_culled_splats(case):
    """Splats behind the camera, off screen and culled, and splats with
    non-finite parameters: no NaN, and the culled ones get exactly zero
    gradient (the projection's AABB and tile math carry no gradient, and
    invalid splats' input rows pass none). The others match JAX, which is
    given the scene without the non-finite rows: with them its gradient is
    NaN everywhere (its masked padding lanes gather row 0's NaN features,
    and 0·NaN spreads through the chunk products)."""
    (jp, jcfg, jcam), (_, pcfg, pcam), target = train_setup(n=400, seed=6, extent=9.0)
    jp = round_on_axis(jp)
    if case == "nonfinite":
        jp = nonfinite_rows(jp)
    pp = to_torch_params(np_tree(jp), "cpu")
    skip = 5 if case == "nonfinite" else 0  # rows JAX is not given
    proj = gt.preprocess_gaussians(
        pp.to_scene(), pcam, width=pcfg.width, height=pcfg.height,
        tile_w=pcfg.tile_w, tile_h=pcfg.tile_h, tiles_x=pcfg.tiles_x,
        tiles_y=pcfg.tiles_y, sh_degree=pcfg.sh_degree, quantize_centers=False,
    )
    culled = ~proj.valid.numpy()
    behind = proj.depth.numpy() < 0
    assert behind.sum() > 50 and (culled & ~behind).sum() > 50
    assert proj.valid.sum() > 20 and culled[:5].all() == (case == "nonfinite")
    assert not culled[5] and float(proj.conic[5, 0]) == float(proj.conic[5, 2])
    jg = jax.jit(jax.grad(jax_mse_plain_gather), static_argnums=(3,))(
        jax.tree.map(lambda x: x[skip:], jp), jcam, jnp.asarray(target), jcfg)
    for kernel in (True, False):
        _, pg = port_grads(gt.mse_loss, pp, pcam, target,
                           dataclasses.replace(pcfg, diff_kernel=kernel))
        for f in LEAVES:
            g = getattr(pg, f).grad.numpy()
            assert np.isfinite(g).all(), f
            assert np.abs(g[culled]).max() == 0.0, f
            b = np.asarray(getattr(jg, f))
            assert np.abs(g[skip:] - b).max() <= GRAD_TOL * np.abs(b).max(), f


def test_ssim_matches_jax():
    rng = np.random.default_rng(11)
    a = rng.random((3, 40, 48), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal((3, 40, 48)).astype(np.float32), 0, 1)
    want = float(jtrain.ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(gt.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= 1e-6
    assert float(gt.ssim(torch.from_numpy(a), torch.from_numpy(a))) > 0.9999
