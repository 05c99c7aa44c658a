"""Multi-device rendering of the port (``gaussianrenderer_tpu_torch.parallel``)
on 4 gloo ranks on the CPU, against the port's single-device frame and
the JAX package.

Gates:
- host geometry (strip and rect balancing, loads, caps, the geometry
  checks) returns the JAX package's tuples and arrays and raises its
  ``ValueError`` messages;
- every case of ``FRAMES`` is the same on all 4 ranks, reports no
  overflow, and is within the JAX package's multi-chip tolerances of the
  port's single-device ``render_frame`` (tests/test_multichip.py): 2e-5
  for the f32 ``gather32`` exchange on the xla and diff compositors, 2e-4
  for the packed path;
- one ``a2a_q`` rect frame against the JAX package's
  ``render_frame_multichip`` on a 4-device CPU mesh: the gates the port's
  single-device packed frames hold against JAX (tests/test_torch_render.py:
  max |Δ| ≤ 1e-3, PSNR ≥ 60 dB);
- ``spawn`` fails a run whose rank raises while another waits in a
  collective, and a run that hangs, within its deadline.

The ranks start once for the module (``spawn``); the rank side imports
only torch and the port.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch import parallel as par
from gaussianrenderer_tpu_torch.parallel import multichip as mc

D = 4
#: tests/test_multichip.py's tolerances.
ATOL_F32 = 2e-5
ATOL_PACKED = 2e-4
#: The JAX frame: the port's multi-device frame against its single-device
#: frame (measured 6e-8), and its gap to JAX's past the single device's.
ATOL_JAX_FRAME = 1e-6
RANK_TIMEOUT = 240.0
#: 2×2 rects over the 4×8 tile grid, uneven in rows and columns.
RECTS = ((0, 3, 8), ((0, 1, 4), (0, 3, 4)))
#: Balanced strips with an empty third strip.
BOUNDS = (0, 2, 3, 3, 8)


def camera(w, h, pos=(0.0, 0.0, 6.0)):
    cam = gt.Camera()
    cam.set_position(list(pos))
    cam.set_look_at([0.0, 0.0, 0.0])
    cam.set_fov_y(60.0)
    cam.set_aspect_ratio(w / h)
    cam.set_clipping_planes(0.2, 100.0)
    cam.update_camera_matrices()
    return cam


def frame_setup(compositor="packed", n=500, h=128, w=128, scene=None, cfg=None):
    """tests/test_multichip.py's setup in the port: 500 splats, 128×128 on
    a 4×8 tile grid, camera at (0, 0, 6)."""
    s = gt.make_random_scene(n, seed=3, device="cpu", **(scene or {}))
    c = gt.RenderConfig(height=h, width=w, compositor=compositor, num_tile_x=4,
                        num_tile_y=8, **(cfg or {}))
    return s, camera(w, h).params(c.k_sigma, device="cpu"), c


#: name → (frame_setup kwargs, render_frame_multichip kwargs, time, atol).
FRAMES = {
    "xla_gather32": (dict(compositor="xla"), {}, None, ATOL_F32),
    "xla_balanced_empty_strip": (dict(compositor="xla"), dict(strip_bounds=BOUNDS), None,
                                 ATOL_F32),
    "diff_gather32": (dict(compositor="diff"), {}, None, ATOL_F32),
    "diff_balanced_bg_alpha": (
        dict(compositor="diff", cfg=dict(background=(1.0, 1.0, 1.0), output_alpha=True)),
        dict(strip_bounds=BOUNDS), None, ATOL_F32),
    "packed_gather32": (dict(), dict(exchange="gather32"), None, ATOL_PACKED),
    "packed_gather_q": (dict(), dict(exchange="gather_q"), None, ATOL_PACKED),
    "packed_a2a_q": (dict(), dict(exchange="a2a_q"), None, ATOL_PACKED),
    "packed_balanced_empty_strip_gather_q": (dict(), dict(strip_bounds=BOUNDS), None,
                                             ATOL_PACKED),
    "packed_balanced_empty_strip_a2a_q": (
        dict(), dict(strip_bounds=BOUNDS, exchange="a2a_q"), None, ATOL_PACKED),
    "packed_rects_gather32": (dict(), dict(strip_rects=RECTS, exchange="gather32"), None,
                              ATOL_PACKED),
    "packed_rects_gather_q": (dict(), dict(strip_rects=RECTS), None, ATOL_PACKED),
    "packed_rects_a2a_q": (dict(), dict(strip_rects=RECTS, exchange="a2a_q"), None,
                           ATOL_PACKED),
    "packed_bg_alpha_depth_a2a_q": (
        dict(cfg=dict(background=(0.2, 0.5, 1.0), output_alpha=True, output_depth=True)),
        dict(exchange="a2a_q"), None, ATOL_PACKED),
    "packed_wide_a2a_q": (dict(scene=dict(scale_range=(0.05, 0.5))),
                          dict(exchange="a2a_q"), None, ATOL_PACKED),
    "packed_wide_rects_a2a_q": (dict(scene=dict(scale_range=(0.05, 0.5))),
                                dict(exchange="a2a_q", strip_rects=RECTS), None,
                                ATOL_PACKED),
    "packed_spacetime_a2a_q": (dict(scene=dict(spacetime=True)), dict(exchange="a2a_q"),
                               0.37, ATOL_PACKED),
    "diff_spacetime": (dict(compositor="diff", scene=dict(spacetime=True)), {}, 0.37,
                       ATOL_F32),
}

#: The frame held against the JAX package: a tiny packed frame, a2a_q
#: over 2×2 rects of a 2×4 tile grid.
JAX_FRAME = dict(n=300, h=64, w=64)
JAX_RECTS = ((0, 2, 4), ((0, 1, 2), (0, 1, 2)))


def jax_frame_setup():
    s = gt.make_random_scene(JAX_FRAME["n"], seed=5, device="cpu")
    c = gt.RenderConfig(height=JAX_FRAME["h"], width=JAX_FRAME["w"], num_tile_x=2,
                        num_tile_y=4)
    return s, camera(c.width, c.height).params(c.k_sigma, device="cpu"), c


def _wide_records(scene, camp, cfg, mesh, strip_rects):
    """Records of this rank's shard that span 3 or more strips."""
    proj = mc._probe(scene, camp, cfg)
    bounds = tuple(i * (cfg.tiles_y // D) for i in range(D + 1))
    *_, wide = mc._destinations(proj.tile_min[:, 1], proj.tile_max[:, 1], proj.valid,
                                bounds, strip_rects, proj.tile_min[:, 0],
                                proj.tile_max[:, 0])
    return int(wide.sum())


def rank_frames(mesh):
    """Every frame of FRAMES and the JAX frame on this rank."""
    out = {}
    for name, (setup_kw, kw, tv, _) in FRAMES.items():
        scene, camp, cfg = frame_setup(**setup_kw)
        shard = par.shard_scene(scene, mesh)
        fb, stats = par.render_frame_multichip(shard, camp, cfg, mesh, time_value=tv, **kw)
        out[name] = dict(fb=fb.numpy(), overflow=bool(stats["overflow"]),
                         clipped=bool(stats["center_clipped"]),
                         wide=_wide_records(shard, camp, cfg, mesh, kw.get("strip_rects")),
                         bytes={k: v for k, v in mc.last_frame.items() if k != "instances"},
                         instances=int(mc.last_frame["instances"]))
    scene, camp, cfg = jax_frame_setup()
    fb, stats = par.render_frame_multichip(par.shard_scene(scene, mesh), camp, cfg, mesh,
                                           exchange="a2a_q", strip_rects=JAX_RECTS)
    out["jax"] = dict(fb=fb.numpy(), overflow=bool(stats["overflow"]))
    return out


@pytest.fixture(scope="module")
def ranks():
    return par.spawn(rank_frames, D, backend="gloo", device="cpu", timeout=RANK_TIMEOUT)


def single_frame(name):
    setup_kw, _, tv, _ = FRAMES[name]
    scene, camp, cfg = frame_setup(**setup_kw)
    fb, stats = gt.render_frame(scene, camp, cfg, time_value=tv)
    return fb.detach().numpy(), stats


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_matches_single_device(ranks, name):
    want, stats = single_frame(name)
    got = ranks[0][name]
    assert got["fb"].shape == want.shape
    assert not got["overflow"] and not bool(stats.overflow)
    assert got["clipped"] == bool(stats.center_clipped or False)
    for r in range(1, D):
        np.testing.assert_array_equal(ranks[r][name]["fb"], got["fb"])
    np.testing.assert_allclose(got["fb"], want, atol=FRAMES[name][3], rtol=0)
    assert np.abs(want).max() > 0


def test_wide_frames_have_records_on_three_strips(ranks):
    """The wide-splat cases exercise the wide records (≥ 3 strips), which
    ride to every rank."""
    for name in ("packed_wide_a2a_q", "packed_wide_rects_a2a_q"):
        assert sum(r[name]["wide"] for r in ranks) > 0, name


@pytest.mark.parametrize("name", ["packed_gather_q", "packed_a2a_q", "packed_rects_a2a_q",
                                  "packed_balanced_empty_strip_gather_q", "xla_gather32"])
def test_strip_instances_add_up_to_the_single_device(ranks, name):
    """Strips partition the tiles, so the ranks' instances sum to the
    single device's."""
    _, stats = single_frame(name)
    assert sum(r[name]["instances"] for r in ranks) == int(stats.num_instances) > 0


def test_a2a_moves_fewer_record_bytes_than_gathers(ranks):
    """gather_q receives 28 B records where gather32 receives 88 B, and
    a2a_q (32 B: the record and its scene index) receives fewer bytes
    than gather_q on every rank."""
    for r in ranks:
        g32 = r["packed_gather32"]["bytes"]["records_received"]
        gq = r["packed_gather_q"]["bytes"]["records_received"]
        a2a = r["packed_a2a_q"]["bytes"]["records_received"]
        assert gq * 22 == g32 * 7
        assert (a2a - 3 * 8 * D) % 32 == 0
        assert a2a - 3 * 8 * D < gq


def test_a2a_rects_match_jax_multichip(ranks):
    """The port's a2a_q rect frame against the JAX package's
    render_frame_multichip on a 4-device CPU mesh (its Pallas compositor
    interpreted: the one JAX multi-chip call of the file): within 1e-6 of
    the port's single-device frame and no further from JAX's."""
    import jax

    from gaussianrenderer_tpu.config import RenderConfig as JaxConfig
    from gaussianrenderer_tpu.parallel import make_mesh as jax_make_mesh
    from gaussianrenderer_tpu.parallel import render_frame_multichip as jax_multichip
    from gaussianrenderer_tpu.parallel import shard_scene as jax_shard_scene
    from gaussianrenderer_tpu.scene.camera import CameraParams as JaxCameraParams
    from gaussianrenderer_tpu.scene.gaussians import GaussianScene as JaxScene

    from test_torch_common import psnr_np

    scene, camp, cfg = jax_frame_setup()
    js = JaxScene(*(None if x is None else x.numpy() for x in scene))
    jcam = JaxCameraParams(*(x.numpy() for x in camp))
    # A ladder wide enough that the JAX frame drops nothing.
    jcfg = JaxConfig(height=cfg.height, width=cfg.width, num_tile_x=cfg.num_tile_x,
                     num_tile_y=cfg.num_tile_y, tier_boost=3)
    mesh = jax_make_mesh(jax.devices()[:D])
    jfb, jstats = jax_multichip(jax_shard_scene(js, mesh), jcam, jcfg, mesh,
                                exchange="a2a_q", strip_rects=JAX_RECTS)
    jfb = np.asarray(jfb)
    got = ranks[0]["jax"]
    assert not bool(jstats["overflow"]) and not got["overflow"]
    assert got["fb"].shape == jfb.shape
    assert psnr_np(got["fb"], jfb) >= 60.0
    # The port's single-device frame differs from JAX's by 1.7e-3 on this
    # frame, all of it JAX's expanded (mxu_q) quadratic form on its 32×16
    # tiles: the port is JAX's direct form to 1.2e-7, and JAX's
    # multi-device frame is its single-device frame to 6e-8
    # (tests/test_torch_small_tile_gap.py). The port's multi-device frame
    # adds nothing beyond float rounding (6e-8 on this frame).
    single = gt.render_frame(scene, camp, cfg)[0].numpy()
    assert np.abs(got["fb"] - single).max() <= ATOL_JAX_FRAME
    assert np.abs(got["fb"] - jfb).max() <= np.abs(single - jfb).max() + ATOL_JAX_FRAME


# ------------------------------------------------------------ host geometry
def _jax_mc():
    from gaussianrenderer_tpu.parallel import multichip as jmc

    return jmc


@pytest.mark.parametrize("n_strips", [1, 3, 4, 8, 40])
def test_balance_strip_bounds_matches_jax(n_strips):
    rng = np.random.default_rng(n_strips)
    loads = rng.integers(0, 1000, 34) * (rng.uniform(size=34) > 0.3)
    assert par.balance_strip_bounds(loads, n_strips) == \
        _jax_mc().balance_strip_bounds(loads, n_strips)


def test_loads_from_rects_match_jax():
    rng = np.random.default_rng(0)
    n, tx, ty = 400, 12, 9
    tmin = rng.integers(-3, 12, (n, 2)).astype(np.int32)
    tmax = tmin + rng.integers(0, 6, (n, 2)).astype(np.int32)
    valid = rng.uniform(size=n) > 0.2
    w = tmax[:, 0] - tmin[:, 0] + 1
    jmc = _jax_mc()
    np.testing.assert_array_equal(
        par.row_loads_from_rects(tmin[:, 1], tmax[:, 1], w, valid, ty),
        jmc.row_loads_from_rects(tmin[:, 1], tmax[:, 1], w, valid, ty))
    tiles = par.tile_loads_from_rects(tmin, tmax, valid, tx, ty)
    np.testing.assert_array_equal(tiles, jmc.tile_loads_from_rects(tmin, tmax, valid, tx, ty))
    for n_strips in (2, 4, 6):
        assert par.balance_strip_rects(tiles, n_strips) == \
            jmc.balance_strip_rects(tiles, n_strips)


@pytest.mark.parametrize("args", [
    ((0, 2, 3, 3, 8), 4, 8),
    ((0, 8), 1, 8),
    ((0, 3, 2, 8), 3, 8),
    ((0, 2, 8), 3, 8),
    ((1, 4, 8), 2, 8),
    ((0, 4, 7), 2, 8),
])
def test_strip_geometry_matches_jax(args):
    jmc = _jax_mc()
    try:
        want = jmc.strip_geometry(*args)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("(", r"\(").replace(")", r"\)")):
            par.strip_geometry(*args)
        return
    assert par.strip_geometry(*args) == want


@pytest.mark.parametrize("args", [
    (RECTS, 4, 8, 4),
    (((0, 8), ((0, 1, 2, 3, 4),)), 4, 8, 4),
    (((0, 3, 8), ((0, 1, 4), (0, 3))), 4, 8, 4),
    (((0, 3, 8), ((0, 1, 4),)), 4, 8, 4),
    (((0, 9), ((0, 4),)), 1, 8, 4),
    (((0, 3, 8), ((0, 1, 4), (0, 3, 4))), 3, 8, 4),
    (((0, 5, 3, 8), ((0, 4), (0, 4), (0, 4))), 3, 8, 4),
])
def test_rect_geometry_matches_jax(args):
    jmc = _jax_mc()
    try:
        want = jmc.rect_geometry(*args)
    except ValueError as e:
        msg = str(e)
        with pytest.raises(ValueError) as got:
            par.rect_geometry(*args)
        assert str(got.value) == msg
        return
    assert par.rect_geometry(*args) == want


def test_scene_calibrations_match_jax():
    """strip_row_loads, balance_strips_for_scene, balance_rects_for_scene,
    a2a_caps_for_scene and default_a2a_caps on one scene and pose in both
    packages."""
    from gaussianrenderer_tpu.config import RenderConfig as JaxConfig

    from test_torch_common import both_cameras, both_scenes

    js, ps = both_scenes(3000, seed=4, scale_range=(0.02, 0.3))
    kw = dict(height=160, width=192, num_tile_x=6, num_tile_y=10)
    jcfg, pcfg = JaxConfig(**kw), gt.RenderConfig(**kw)
    jcam, pcam, _ = both_cameras(192, 160, pos=(0.3, 0.8, 5.0))
    jcam2, pcam2, _ = both_cameras(192, 160, pos=(-1.0, 0.2, 5.5))
    jmc = _jax_mc()
    np.testing.assert_array_equal(par.strip_row_loads(ps, pcam, pcfg),
                                  jmc.strip_row_loads(js, jcam, jcfg))
    for d in (2, 5):
        assert par.balance_strips_for_scene(ps, pcam, pcfg, d) == \
            jmc.balance_strips_for_scene(js, jcam, jcfg, d)
        assert par.balance_rects_for_scene(ps, pcam, pcfg, 4) == \
            jmc.balance_rects_for_scene(js, jcam, jcfg, 4)
        assert par.a2a_caps_for_scene(ps, [pcam, pcam2], pcfg, 5) == \
            jmc.a2a_caps_for_scene(js, [jcam, jcam2], jcfg, 5)
        assert par.default_a2a_caps(3000, d) == jmc.default_a2a_caps(3000, d)
    bounds = (0, 1, 4, 10)
    assert par.a2a_caps_for_scene(ps, pcam, pcfg, 3, strip_bounds=bounds, margin=2.0) == \
        jmc.a2a_caps_for_scene(js, jcam, jcfg, 3, strip_bounds=bounds, margin=2.0)
    with pytest.raises(ValueError, match="not divisible"):
        par.a2a_caps_for_scene(ps, pcam, pcfg, 3)


def test_render_frame_multichip_rejects_bad_arguments():
    """The JAX function's argument errors, raised before any collective."""
    scene, camp, cfg = frame_setup()
    mesh = mc.Mesh(None, 0, 3, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="unknown exchange"):
        par.render_frame_multichip(scene, camp, cfg, mesh, exchange="bogus")
    with pytest.raises(ValueError, match="divisible by mesh size 3"):
        par.render_frame_multichip(scene, camp, cfg, mesh)
    with pytest.raises(ValueError, match="non-decreasing"):
        par.render_frame_multichip(scene, camp, cfg, mesh, strip_bounds=(0, 5, 4, 8))
    with pytest.raises(ValueError, match="OR strip_rects"):
        par.render_frame_multichip(scene, camp, cfg, mesh, strip_bounds=(0, 2, 4, 8),
                                   strip_rects=RECTS)
    xla = dataclasses.replace(cfg, compositor="xla")
    with pytest.raises(ValueError, match="packed compositor"):
        par.render_frame_multichip(scene, camp, xla, mesh, strip_rects=RECTS)
    # Rects are checked against the mesh, not against equal strips.
    with pytest.raises(ValueError, match="yields 4 rects for 3 chips"):
        par.render_frame_multichip(scene, camp, cfg, mesh, strip_rects=RECTS)


def test_choose_backend():
    assert par.choose_backend(4, "cpu") == "gloo"
    want = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    assert par.choose_backend(2, "cuda") == want


# ------------------------------------------------------------- hang guard
def rank_raises_in_collective(mesh):
    """Rank 1 raises while the others wait in an all-reduce it never
    joins."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 gives up")
    x = torch.ones(4)
    torch.distributed.all_reduce(x)
    return float(x[0])


def rank_hangs(mesh):
    time.sleep(600)


def test_spawn_fails_fast_when_a_rank_raises():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        par.spawn(rank_raises_in_collective, 2, backend="gloo", device="cpu", timeout=120.0)
    assert time.monotonic() - t0 < 60.0


def test_spawn_kills_hung_ranks_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within"):
        par.spawn(rank_hangs, 2, backend="gloo", device="cpu", timeout=8.0)
    assert time.monotonic() - t0 < 40.0
