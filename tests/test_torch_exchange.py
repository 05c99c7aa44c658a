"""The multi-device record exchange of the port, against the JAX package
on the CPU, and its all-to-all on 4 gloo ranks.

Gates:
- ``encode_record_rows`` is bit-equal to the JAX function on a seeded
  projection with coarse (off-screen-centre) splats and on a synthetic
  one that reaches every branch (fine, coarse, saturated, invalid);
  ``decode_record_rows`` of those rows equals the JAX decode field for
  field, the saturation flag included; ``packed_valid_np`` equals JAX's;
- ``GaussianScene.pad_to`` and ``build_sorted_instances(depth_bits=...)``
  equal the JAX functions;
- on the ranks: the ``a2a_q`` exchange receives exactly the records the
  JAX package's order prescribes (first-destination records source-major
  in scene order, then the 2-strip straddlers, then the wide records),
  with their global scene indices, for row strips and for rects; frames with window capacities the JAX
  exchange would overflow, with calibrated caps on balanced strips, and
  on a scene padded to the mesh, within 2e-4 of the single-device frame
  (tests/test_exchange.py) with no overflow.
"""

import numpy as np
import pytest
import torch

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch import parallel as par
from gaussianrenderer_tpu_torch.ops import instances as pin
from gaussianrenderer_tpu_torch.ops.projection import ProjectedGaussians
from gaussianrenderer_tpu_torch.parallel import multichip as mc

D = 4
ATOL_PACKED = 2e-4
RANK_TIMEOUT = 240.0
BOUNDS = (0, 2, 3, 3, 8)
RECTS = ((0, 3, 8), ((0, 1, 4), (0, 3, 4)))
#: Seeded records per rank for the exchange-order cases.
ORDER_NS = 300


def order_inputs(rank, tiles_y=8, tiles_x=4):
    """This rank's seeded exchange inputs: rows whose row 0 is the
    record's global index, tile rects of 1–6 rows and columns (so some
    records straddle and some are wide), about a tenth invalid."""
    rng = np.random.default_rng(100 + rank)
    n = ORDER_NS
    tmin_y = rng.integers(0, tiles_y, n)
    tmax_y = np.minimum(tmin_y + rng.choice([0, 0, 0, 1, 2, 5], n), tiles_y - 1)
    tmin_x = rng.integers(0, tiles_x, n)
    tmax_x = np.minimum(tmin_x + rng.choice([0, 0, 1, 3], n), tiles_x - 1)
    valid = rng.uniform(size=n) > 0.1
    rows = rng.integers(0, 2**32, (pin.EXCHANGE_ROWS, n), dtype=np.int64)
    rows[0] = rank * n + np.arange(n)
    return rows, tmin_y, tmax_y, tmin_x, tmax_x, valid


def expected_order(rank, strip_rects):
    """The JAX package's receive order for ``rank`` from every rank's
    inputs, by its routing rules written out on the host."""
    main, strad, wide = [], [], []
    for src in range(D):
        rows, tmin_y, tmax_y, tmin_x, tmax_x, valid = order_inputs(src)
        for i in range(ORDER_NS):
            if not valid[i]:
                continue
            if strip_rects is None:
                s0 = int(np.searchsorted(BOUNDS[1:-1], tmin_y[i], side="right"))
                s1 = int(np.searchsorted(BOUNDS[1:-1], tmax_y[i], side="right"))
                dests = list(range(s0, s1 + 1))
            else:
                dests, base = [], 0
                row_b, col_b = strip_rects
                for b in range(len(row_b) - 1):
                    cb = col_b[b]
                    if tmin_y[i] <= row_b[b + 1] - 1 and tmax_y[i] >= row_b[b]:
                        c0 = int(np.searchsorted(cb[1:-1], tmin_x[i], side="right"))
                        c1 = int(np.searchsorted(cb[1:-1], tmax_x[i], side="right"))
                        dests += [base + c for c in range(c0, c1 + 1)]
                    base += len(cb) - 1
            if len(dests) >= 3:
                wide.append(rows[0, i])
            elif dests[0] == rank:
                main.append(rows[0, i])
            elif len(dests) == 2 and dests[1] == rank:
                strad.append(rows[0, i])
    return main, strad, wide


def frame_setup(n=500, scene=None):
    """tests/test_exchange.py's setup: 128×128 on a 4×8 tile grid."""
    s = gt.make_random_scene(n, seed=3, device="cpu", **(scene or {}))
    cam = gt.Camera()
    cam.set_position([0.0, 0.0, 6.0])
    cam.set_look_at([0.0, 0.0, 0.0])
    cam.set_fov_y(60.0)
    cam.set_aspect_ratio(1.0)
    cam.set_clipping_planes(0.2, 100.0)
    cam.update_camera_matrices()
    cfg = gt.RenderConfig(height=128, width=128, compositor="packed", num_tile_x=4,
                          num_tile_y=8)
    return s, cam.params(cfg.k_sigma, device="cpu"), cfg


#: name → (frame_setup kwargs, render_frame_multichip kwargs).
FRAMES = {
    # The JAX exchange flags overflow at these capacities; exact counts
    # cannot.
    "a2a_caps_too_small": (dict(), dict(exchange="a2a_q", a2a_caps=(1, 1, 1))),
    "a2a_calibrated_caps_balanced": (dict(scene=dict(scale_range=(0.05, 0.5))),
                                     dict(exchange="a2a_q", strip_bounds=BOUNDS,
                                          a2a_caps="calibrate")),
    "gather_q_padded_scene": (dict(n=501), dict(exchange="gather_q")),
    "a2a_padded_scene_rects": (dict(n=503), dict(exchange="a2a_q", strip_rects=RECTS)),
}


def rank_exchange(mesh):
    out = {"order": {}, "frames": {}}
    for label, rects in (("strips", None), ("rects", RECTS)):
        rows, tmin_y, tmax_y, tmin_x, tmax_x, valid = order_inputs(mesh.rank)
        t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
        got, index = mc._exchange_a2a(mesh, t(rows), t(tmin_y), t(tmax_y), t(valid),
                                      bounds=BOUNDS if rects is None else None,
                                      strip_rects=rects, tmin_x=t(tmin_x), tmax_x=t(tmax_x))
        out["order"][label] = (got.numpy(), index.numpy())
    for name, (setup_kw, kw) in FRAMES.items():
        scene, camp, cfg = frame_setup(**setup_kw)
        kw = dict(kw)
        if kw.get("a2a_caps") == "calibrate":
            kw["a2a_caps"] = par.a2a_caps_for_scene(scene, camp, cfg, D,
                                                    strip_bounds=kw["strip_bounds"])
        fb, stats = par.render_frame_multichip(par.shard_scene(scene, mesh), camp, cfg,
                                               mesh, **kw)
        out["frames"][name] = dict(fb=fb.numpy(), overflow=bool(stats["overflow"]),
                                   clipped=bool(stats["center_clipped"]))
    return out


@pytest.fixture(scope="module")
def ranks():
    return par.spawn(rank_exchange, D, backend="gloo", device="cpu", timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("label", ["strips", "rects"])
def test_a2a_receive_order_is_jax_order(ranks, label):
    rects = None if label == "strips" else RECTS
    n_strad = n_wide = 0
    for r in range(D):
        main, strad, wide = expected_order(r, rects)
        got, index = ranks[r]["order"][label]
        assert got.shape[0] == pin.EXCHANGE_ROWS
        np.testing.assert_array_equal(got[0], np.array(main + strad + wide, np.int64))
        np.testing.assert_array_equal(index, got[0])  # row 0 holds the global index
        # Every row of a record travels unchanged.
        for src in range(D):
            rows = order_inputs(src)[0]
            sel = (got[0] >= src * ORDER_NS) & (got[0] < (src + 1) * ORDER_NS)
            np.testing.assert_array_equal(got[:, sel], rows[:, got[0, sel] - src * ORDER_NS])
        n_strad += len(strad)
        n_wide = len(wide)
    assert n_strad > 0 and n_wide > 0


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_exchange_frame_matches_single_device(ranks, name):
    setup_kw, _ = FRAMES[name]
    scene, camp, cfg = frame_setup(**setup_kw)
    want, stats = gt.render_frame(scene, camp, cfg)
    got = ranks[0]["frames"][name]
    assert not got["overflow"]
    assert got["clipped"] == bool(stats.center_clipped)
    for r in range(1, D):
        np.testing.assert_array_equal(ranks[r]["frames"][name]["fb"], got["fb"])
    np.testing.assert_allclose(got["fb"], want.numpy(), atol=ATOL_PACKED, rtol=0)


# ------------------------------------------------------- against JAX (CPU)
def _jax_proj_numpy(jproj):
    return {f: np.asarray(getattr(jproj, f)) for f in jproj._fields}


def _port_proj(arrays):
    return ProjectedGaussians(**{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})


def coarse_projection():
    """The JAX package's projection of a seeded scene whose six giant
    splats sit far to the side of a 640×480 frame: valid, five with
    centers more than 2048 pixels off screen (the coarse carrier), plus
    its config."""
    from gaussianrenderer_tpu.config import RenderConfig as JaxConfig
    from gaussianrenderer_tpu.ops.projection import preprocess_gaussians
    from gaussianrenderer_tpu.scene.gaussians import GaussianScene

    from test_torch_common import both_cameras, both_scenes

    js, _ = both_scenes(400, seed=7, scale_range=(0.02, 0.3))
    pos, scales = np.array(js.positions), np.array(js.scales)
    pos[:6] = [[x, 0.0, 0.0] for x in (-30, -60, -120, -250, -500, -1000)]
    scales[:6] = 40.0
    js = GaussianScene(pos, np.asarray(js.sh), np.asarray(js.opacity), scales,
                       np.asarray(js.quats))
    cfg = JaxConfig(height=480, width=640)
    jcam, _, _ = both_cameras(640, 480)
    proj = preprocess_gaussians(js, jcam, width=cfg.width, height=cfg.height,
                                tile_w=cfg.tile_w, tile_h=cfg.tile_h, tiles_x=cfg.tiles_x,
                                tiles_y=cfg.tiles_y, sh_degree=cfg.sh_degree)
    return proj, cfg


def synthetic_projection(n=600, seed=11):
    """Random fields that reach every encode branch: centers in the fine
    window, in the coarse one and beyond it; conics near degenerate;
    opacities and colors outside [0, 1]; a tenth invalid."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-200, 400, (n, 2))
    c[: n // 4] = rng.uniform(-9000, 9000, (n // 4, 2))  # coarse
    c[: n // 20] = rng.uniform(-70000, 70000, (n // 20, 2))  # beyond coarse
    c = np.round(c * 8) / 8
    a = rng.uniform(1e-6, 2.0, n)
    cc = rng.uniform(1e-6, 2.0, n)
    b = rng.uniform(-1, 1, n) * 2 * np.sqrt(a * cc)
    lo = rng.integers(-50, 5000, (n, 2))
    hi = lo + rng.integers(0, 300, (n, 2))
    return dict(
        valid=rng.uniform(size=n) > 0.1,
        depth=rng.uniform(0.1, 100.0, n).astype(np.float32),
        color=rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32),
        opacity=rng.uniform(-0.05, 1.05, n).astype(np.float32),
        center_px=c.astype(np.float32),
        conic=np.stack([a, b, cc], 1).astype(np.float32),
        aabb_px=np.concatenate([lo, hi], 1).astype(np.float32),
        tile_min=(np.clip(lo, 0, None) // 32).astype(np.int32),
        tile_max=(np.clip(hi, 0, None) // 32).astype(np.int32),
    )


def _check_record(arrays, geom):
    from gaussianrenderer_tpu.ops import instances as jin
    from gaussianrenderer_tpu.ops.projection import ProjectedGaussians as JaxProj

    jrows = np.asarray(jin.encode_record_rows(JaxProj(**arrays))).astype(np.int64)
    prows = pin.encode_record_rows(_port_proj(arrays))
    assert prows.dtype == torch.int64 and prows.shape == jrows.shape
    np.testing.assert_array_equal(prows.numpy(), jrows)
    jdec, jsat = jin.decode_record_rows(np.asarray(jrows, np.uint32), **geom)
    pdec, psat = pin.decode_record_rows(prows, **geom)
    np.testing.assert_array_equal(psat.numpy(), np.asarray(jsat))
    for f in jdec._fields:
        want = np.asarray(getattr(jdec, f))
        got = getattr(pdec, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    return jrows, np.asarray(jsat)


def test_record_rows_match_jax_on_coarse_projection():
    proj, cfg = coarse_projection()
    arrays = _jax_proj_numpy(proj)
    geom = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
                tile_h=cfg.tile_h)
    rows, _ = _check_record(arrays, geom)
    coarse = (rows[4] >> 31) & 1
    assert coarse[arrays["valid"]].sum() == 5, "the giant splats ride the coarse carrier"


def test_record_rows_match_jax_on_every_branch():
    arrays = synthetic_projection()
    rows, sat = _check_record(arrays, dict(tiles_x=160, tiles_y=160, tile_w=32, tile_h=32))
    assert ((rows[4] >> 31) & 1).sum() > 50 and sat.sum() > 5


def test_packed_valid_np_matches_jax():
    from gaussianrenderer_tpu.ops.instances import packed_valid_np

    rng = np.random.default_rng(0)
    valid = rng.uniform(size=5000) > 0.2
    op = np.concatenate([rng.uniform(0, 0.003, 2500), rng.uniform(0, 1, 2500)]).astype(
        np.float32)
    got = pin.packed_valid_np(valid, op)
    np.testing.assert_array_equal(got, packed_valid_np(valid, op))
    assert 0 < got.sum() < valid.sum()


def test_pad_to_matches_jax():
    from test_torch_common import both_scenes

    js, ps = both_scenes(10, seed=1, spacetime=True)
    assert ps.pad_to(10) is ps
    jp, pp = js.pad_to(16), ps.pad_to(16)
    assert pp.num_gaussians == 16
    for f in ps._fields:
        np.testing.assert_array_equal(getattr(pp, f).numpy(), np.asarray(getattr(jp, f)),
                                      err_msg=f)
    with pytest.raises(ValueError, match="capacity 9 < scene size 10"):
        ps.pad_to(9)


@pytest.mark.parametrize("depth_bits", [10, 22])
def test_build_sorted_instances_depth_bits_matches_jax(depth_bits):
    from gaussianrenderer_tpu.ops.tiling import build_sorted_instances as jax_build_sorted

    from test_torch_tiling import project_both

    jproj, pproj, jcfg, pcfg, jcam, pcam = project_both("wide_128x160")
    n = int(pproj.valid.shape[0])
    ja = jax_build_sorted(jproj, tiles_x=jcfg.tiles_x, num_tiles=jcfg.num_tiles,
                          capacity=jcfg.instance_capacity(n) * 4, near=jcam.near,
                          far=jcam.far, depth_bits=depth_bits)
    pa = gt.build_sorted_instances(pproj, tiles_x=pcfg.tiles_x, num_tiles=pcfg.num_tiles,
                                   near=pcam.near, far=pcam.far, depth_bits=depth_bits)
    total = int(ja.total_instances)
    assert total > 500 and int(pa.total_instances) == total
    np.testing.assert_array_equal(np.asarray(ja.gaussian_id)[:total], pa.gaussian_id.numpy())
    np.testing.assert_array_equal(np.asarray(ja.tile_id)[:total], pa.tile_id.numpy())
    np.testing.assert_array_equal(np.asarray(ja.tile_start), pa.tile_start.numpy())
    np.testing.assert_array_equal(np.asarray(ja.tile_count), pa.tile_count.numpy())
    with pytest.raises(ValueError, match="> 32"):
        gt.build_sorted_instances(pproj, tiles_x=pcfg.tiles_x, num_tiles=pcfg.num_tiles,
                                  depth_bits=30)
