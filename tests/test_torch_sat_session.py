"""Culled frames: the port's ``render_frame(..., sat_state=...)`` and
``make_renderer`` against the JAX package's, on the CPU.

A session of three frames on a dense overdraw scene (most 16×16 blocks
saturate), starting from ``initial_cutoff``, at one pose here and
orbiting 3° a frame in test_torch_sat_orbit.py (the JAX package's own
``test_orbit_coherence_psnr_and_risk`` step). For every frame the port
and the JAX package must agree exactly on ``sat_culled``, ``sat_risk``,
``num_culled``, ``num_instances``, ``area_hist``, each tile's instance
count and the new cutoff image (bit for bit); the framebuffers within
60 dB (the JAX frame uses the MXU quadratic, held within 1e-3 of the
port's direct form by the JAX package's own test). No exception was
needed: on these frames the JAX compositor's census agrees with the
port's on every block, so no cutoff had to be explained by a rerun with
``mxu_q=False``.

Also, from ``tests/test_satcull.py``: the same-pose frame 2 culls and
equals the unculled frame within 2e-5 (summation order), and
``make_renderer`` threads the state.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops import satcull as jsat
from gaussianrenderer_tpu.ops.instances import build_packed_instances as jax_build_fn
from gaussianrenderer_tpu.ops.projection import preprocess_gaussians as jax_preprocess
from gaussianrenderer_tpu.render import render_frame as jax_render

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch import render as prender
from gaussianrenderer_tpu_torch.convert import to_torch_camera
from gaussianrenderer_tpu_torch.ops import satcull as psat

from test_torch_common import both_configs, both_scenes, jax_camera, np_tree, psnr_np

SIZE = 96
ORBIT_DEG = 3.0

def poses(orbit):
    """(JAX CameraParams, port CameraParams) of frames 1–3."""
    cam = jax_camera(SIZE, SIZE, pos=(0.0, 0.0, 2.5), fov=70.0)
    out = []
    for f in range(3):
        if orbit and f > 0:
            cam.orbit(ORBIT_DEG, 0.0)
            cam.update_camera_matrices()
        jp = cam.params(3.0)
        out.append((jp, to_torch_camera(np_tree(jp), device="cpu")))
    return out


@functools.partial(jax.jit, static_argnames=("jcfg",))
def _jax_emission(js, jcam, sat_state, jcfg):
    geo = dict(tiles_x=jcfg.tiles_x, tiles_y=jcfg.tiles_y, tile_w=jcfg.tile_w,
               tile_h=jcfg.tile_h)
    proj = jax_preprocess(js, jcam, width=jcfg.width, height=jcfg.height, **geo)
    sy, sx = jsat.sat_grid(**geo)
    bits = min(32 - max(int(jcfg.num_tiles).bit_length(), 1), 24)
    step = (jnp.float32(jcam.far) - jnp.float32(jcam.near)) / float((1 << bits) - 1)
    eff = jsat.dilate_cutoff(sat_state, jcfg.sat_dilate)
    culled = jsat.cull_mask(proj.valid, proj.depth, proj.aabb_px, jsat.build_pyramid(eff),
                            sx=sx, sy=sy, margin=jcfg.sat_margin, depth_step=step)
    proj = proj._replace(valid=proj.valid & ~culled)
    cut_q = jsat.tile_cutoff_q(eff, near=jcam.near, depth_step=step, margin=jcfg.sat_margin,
                               **geo)
    inst = jax_build_fn(proj, near=jcam.near, far=jcam.far, tier_boost=jcfg.tier_boost,
                        sat_cut_q=cut_q, **geo)
    return inst.tile_count, inst.overflow


def jax_tile_counts(js, jcam, jcfg, sat_state):
    """Per-tile instance counts of a JAX culled frame: the sat branch of
    the JAX ``_render_impl`` up to emission, in its own words, jitted as
    ``render_frame`` is."""
    counts, overflow = _jax_emission(js, jcam, sat_state, jcfg)
    assert not bool(overflow)
    return np.asarray(counts)


def port_tile_counts(ps, pcam, cfg, sat_state):
    """Per-tile instance counts of the port's culled frame."""
    proj = gt.preprocess_gaussians(
        ps, pcam, width=cfg.width, height=cfg.height, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
    )
    proj, _, cut_q = prender._sat_cull(proj, pcam, cfg, sat_state)
    inst = gt.build_packed_instances(
        proj, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, near=pcam.near, far=pcam.far, sat_cut_q=cut_q,
    )
    return inst.tile_count.numpy()


def make_setup(**cfg_kw):
    """The overdraw scene of ``tests/test_satcull.py`` (30k splats close to
    the camera) in both packages, and both configs at 96×96."""
    js, ps = both_scenes(30000, seed=0, extent=2.0, scale_range=(0.02, 0.08))
    jcfg, cfg = both_configs(height=SIZE, width=SIZE, sat_cull=True, **cfg_kw)
    # A ladder wide enough that the JAX frames drop nothing.
    jcfg = dataclasses.replace(jcfg, tier_boost=3)
    return js, ps, jcfg, cfg


def run_session(setup, orbit):
    """Frames 1–3 of one session in both packages, from the initial state."""
    js, ps, jcfg, cfg = setup
    jstate = jsat.initial_cutoff(jcfg.tiles_x, jcfg.tiles_y, jcfg.tile_w, jcfg.tile_h)
    pstate = psat.initial_cutoff(cfg.tiles_x, cfg.tiles_y, cfg.tile_w, cfg.tile_h,
                                 device="cpu")
    frames = []
    for jp, pp in poses(orbit):
        jfb, jst, jnew = jax_render(js, jp, jcfg, sat_state=jstate)
        pfb, pst, pnew = gt.render_frame(ps, pp, cfg, sat_state=pstate)
        frames.append(dict(
            jfb=np.asarray(jfb), jst=np_tree(jst), jnew=np.asarray(jnew),
            pfb=pfb.numpy(), pst=pst, pnew=pnew,
            jcounts=jax_tile_counts(js, jp, jcfg, jstate),
            pcounts=port_tile_counts(ps, pp, cfg, pstate), pp=pp,
        ))
        jstate, pstate = jnew, pnew
    return frames


def check_frames_match_jax(frames, session):
    """Every frame's counts, cutoff image and framebuffer against JAX's."""
    for f, fr in enumerate(frames):
        jst, pst = fr["jst"], fr["pst"]
        where = f"{session} frame {f + 1}"
        assert int(pst.sat_culled) == int(jst.sat_culled), where
        assert int(pst.sat_risk) == int(jst.sat_risk), where
        assert int(pst.num_culled) == int(jst.num_culled), where
        assert int(pst.num_instances) == int(jst.num_instances) > 0, where
        assert not bool(jst.overflow) and not bool(pst.overflow), where
        np.testing.assert_array_equal(pst.area_hist.numpy(), np.asarray(jst.area_hist))
        np.testing.assert_array_equal(fr["pcounts"], fr["jcounts"])
        assert int(fr["pcounts"].sum()) == int(pst.num_instances)
        assert fr["pnew"].shape == fr["jnew"].shape and fr["pnew"].dtype == torch.float32
        np.testing.assert_array_equal(fr["pnew"].numpy().view(np.uint32),
                                      fr["jnew"].view(np.uint32))
        assert fr["pfb"].shape == fr["jfb"].shape == (3, SIZE, SIZE)
        assert psnr_np(fr["pfb"], fr["jfb"]) >= 60.0, where
    assert int(frames[0]["pst"].sat_culled) == 0
    assert (frames[0]["pnew"] < psat.SAT_NONE).sum() > 10
    assert int(frames[1]["pst"].sat_culled) > 0 and int(frames[2]["pst"].sat_culled) > 0


@pytest.fixture(scope="module")
def setup():
    # sat_dilate=0: the static-camera configuration of the JAX package's
    # exactness test (dilation exists only for motion between frames).
    return make_setup(sat_dilate=0)


@pytest.fixture(scope="module")
def frames(setup):
    return run_session(setup, orbit=False)


def test_culled_frames_match_jax(frames):
    check_frames_match_jax(frames, "same pose")


def test_same_pose_cull_is_exact_and_nontrivial(setup, frames):
    """The port's same-pose frame 2 culls a real share and equals its own
    unculled frame within 2e-5 (only chunk boundaries move, which
    reassociates the f32 sums); no block loses saturation."""
    _, ps, _, cfg = setup
    f1, f2, _ = frames
    unculled, st0 = gt.render_frame(ps, f2["pp"], cfg)
    assert int(f2["pst"].sat_culled) > 0.05 * ps.positions.shape[0]
    assert int(f2["pst"].num_instances) < 0.8 * int(st0.num_instances)
    assert int(f2["pst"].sat_risk) == 0
    np.testing.assert_allclose(f2["pfb"], unculled.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(f1["pfb"], unculled.numpy())


def test_sat_cull_without_state_renders_unculled(setup, frames):
    """``sat_cull=True`` with ``sat_state=None``: two return values, the
    unculled frame, no sat stats."""
    _, ps, _, cfg = setup
    pp = frames[0]["pp"]
    out = gt.render_frame(ps, pp, cfg)
    assert len(out) == 2
    fb, st = out
    assert st.sat_culled is None and st.sat_risk is None
    plain, _ = gt.render_frame(ps, pp, dataclasses.replace(cfg, sat_cull=False))
    torch.testing.assert_close(fb, plain, rtol=0, atol=0)
    # A state without sat_cull is ignored, as in the JAX package.
    out = gt.render_frame(ps, pp, dataclasses.replace(cfg, sat_cull=False),
                          sat_state=frames[0]["pnew"])
    assert len(out) == 2


def test_make_renderer_threads_sat_state(setup, frames):
    _, ps, _, cfg = setup
    render = gt.make_renderer(ps, cfg, auto_tier=True, scene_path="unused.ply")
    assert render.current_cfg() is cfg
    same = frames
    for f in range(3):
        fb, st = render(same[f]["pp"])
        # The session equals the frame-by-frame calls above.
        assert int(st.sat_culled) == int(same[f]["pst"].sat_culled)
        assert int(st.num_instances) == int(same[f]["pst"].num_instances)
        np.testing.assert_array_equal(fb.numpy(), same[f]["pfb"])
    # Without sat_cull the session renders plain frames.
    plain = gt.make_renderer(ps, dataclasses.replace(cfg, sat_cull=False))
    fb, st = plain(same[0]["pp"])
    assert st.sat_culled is None
    np.testing.assert_array_equal(fb.numpy(), same[0]["pfb"])
