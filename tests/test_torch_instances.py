"""Packed-instance emission of the port against the JAX package.

Both emitters get the same projected splats. The JAX side runs with a
tier ladder wide enough that it does not overflow, so both emit every
live (splat, tile) pair. Bit-exact: total instances, per-tile start and
count, the effective-lane histogram and the center-clipped flag. Packed
records are compared per tile as multisets of (depth_q, 5 rows) — with
one stated exception for jitted XLA below — since instances
tied on (tile, depth_q) may come out in another order (the JAX ladder
emits tier by tier, the port splat by splat), and the depth decoded from
the key stands for the key inside a tile.
"""

import jax
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops import sort as jax_sort
from gaussianrenderer_tpu.ops.instances import build_packed_instances
from gaussianrenderer_tpu.ops.projection import ProjectedGaussians as JaxProjected
from gaussianrenderer_tpu.scene.gaussians import GaussianScene as JaxScene

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.convert import to_torch_scene

from test_torch_common import both_cameras, both_configs, both_scenes, needle_scene

jax_build = jax.jit(
    build_packed_instances,
    static_argnames=("tiles_x", "tiles_y", "tile_w", "tile_h", "tier_boost",
                     "want_depth"),
)


def giant_scene():
    """A random scene plus giant splats whose centers project thousands of
    pixels off-screen (COARSE center encode) and one far beyond the coarse
    window (clamped and flagged)."""
    js, _ = both_scenes(300, seed=1)
    gp = np.array([[15.0, 0.0, 5.7], [0.0, -12.0, 5.6], [-18.0, 3.0, 5.75],
                   [400.0, 0.0, 5.75]], np.float32)
    gs = np.array([[6.0] * 3] * 3 + [[200.0] * 3], np.float32)
    js = JaxScene(
        np.concatenate([np.asarray(js.positions), gp]),
        np.concatenate([np.asarray(js.sh), np.full((4, 27), 0.5, np.float32)]),
        np.concatenate([np.asarray(js.opacity), np.full(4, 0.4, np.float32)]),
        np.concatenate([np.asarray(js.scales), gs]),
        np.concatenate([np.asarray(js.quats), np.tile([[1, 0, 0, 0]], (4, 1))]).astype(np.float32),
    )
    return js, to_torch_scene(js, device="cpu")


CASES = {
    "default": lambda: (both_scenes(2000, seed=0), dict(height=128, width=160), {}),
    "wide": lambda: (both_scenes(1500, seed=1, scale_range=(0.05, 0.5)),
                     dict(height=150, width=200), {}),
    "needles": lambda: (needle_scene(), dict(height=120, width=176), {}),
    "giant": lambda: (giant_scene(), dict(height=128, width=128),
                      dict(pos=(0.0, 0.0, 6.0), fov=60.0)),
    "tiles16": lambda: (both_scenes(1000, seed=6),
                        dict(height=96, width=128, num_tile_x=8, num_tile_y=6), {}),
}


def emit_both(case, jax_emitter=None):
    """Both emitters on the same projected splats of ``case`` (the JAX
    one jitted unless ``jax_emitter`` is given)."""
    (js, ps), cfg_kw, cam_kw = CASES[case]()
    _, cfg = both_configs(**cfg_kw)
    jcam, pcam, _ = both_cameras(cfg.width, cfg.height, **cam_kw)
    proj = gt.preprocess_gaussians(
        ps, pcam, width=cfg.width, height=cfg.height, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
    )
    geo = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
               tile_h=cfg.tile_h)
    ji = (jax_emitter or jax_build)(
        JaxProjected(*(f.numpy() for f in proj)), near=jcam.near, far=jcam.far,
        tier_boost=3, want_depth=True, **geo,
    )
    pi = gt.build_packed_instances(
        proj, near=pcam.near, far=pcam.far, want_depth=True, **geo
    )
    return ji, pi, cfg


def per_tile_records(packed, depth, start, count, num_tiles, near=0.2, far=100.0):
    """tile → sorted list of (depth_q, row0, u, row2, row3, row4, w) tuples
    (row 1 split into its chol u and w codes). ``depth_q`` is recovered
    from the decoded depth (a quantization step is ~100 ulps of the depth,
    so an ulp of decode rounding cannot move it)."""
    dmax = (1 << min(32 - int(num_tiles).bit_length(), 24)) - 1
    d = np.rint((depth.astype(np.float64) - near) * dmax / (far - near))
    d = d.astype(np.int64)
    rows = [packed[0], packed[1] >> 16, packed[2], packed[3], packed[4],
            packed[1] & 0xFFFF]
    out = {}
    for t in np.nonzero(count)[0]:
        s, e = start[t], start[t] + count[t]
        out[int(t)] = sorted(zip(d[s:e].tolist(), *(r[s:e].tolist() for r in rows)))
    return out


def assert_records_match(jax_records, port_records, w_codes=0):
    """Per-tile multisets equal; the chol w code may differ by ``w_codes``."""
    assert jax_records.keys() == port_records.keys()
    for t, want in jax_records.items():
        got = port_records[t]
        assert [r[:-1] for r in got] == [r[:-1] for r in want], f"tile {t}"
        dw = np.abs(np.array([r[-1] for r in got]) - np.array([r[-1] for r in want]))
        assert dw.max(initial=0) <= w_codes, f"tile {t}: w codes off by {dw.max()}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_emission_matches(case):
    ji, pi, cfg = emit_both(case)
    assert not bool(ji.overflow) and not bool(pi.overflow)
    total = int(ji.total_instances)
    assert total > 0 and int(pi.total_instances) == total
    assert pi.packed_feats.shape == (5, total) and pi.packed_feats.dtype == torch.int32
    start, count = np.asarray(ji.tile_start), np.asarray(ji.tile_count)
    np.testing.assert_array_equal(start, pi.tile_start.numpy())
    np.testing.assert_array_equal(count, pi.tile_count.numpy())
    np.testing.assert_array_equal(np.asarray(ji.area_hist), pi.area_hist.numpy())
    assert bool(ji.center_clipped) == bool(pi.center_clipped)

    jrec = np.asarray(ji.packed_feats)[:, :total]
    prec = pi.packed_feats.numpy().view(np.uint32)
    jdep = np.asarray(ji.depth_f32)[:total]
    pdep = pi.depth_f32.numpy()
    # XLA fuses the decode near + q·step into an FMA: an ulp apart.
    np.testing.assert_allclose(np.sort(pdep), np.sort(jdep), rtol=2.4e-7, atol=0)
    nt = cfg.num_tiles
    # Under jit XLA contracts C − v·v into an FMA; for needle splats, whose
    # w = √(C − v²) cancels, that moves w's e6m10 code by one (2^-10
    # relative). Against the JAX function run op by op every row is
    # bit-exact (test_torch_encoders.py, needle scene).
    assert_records_match(
        per_tile_records(jrec, jdep, start, count, nt),
        per_tile_records(prec, pdep, start, count, nt),
        w_codes=1,
    )
    # Front to back inside every tile.
    for t in np.nonzero(count)[0]:
        seg = pdep[start[t]:start[t] + count[t]]
        assert np.all(np.diff(seg) >= 0)
    if case == "giant":
        coarse = (prec[3] >> 30) & 1
        assert coarse.any() and bool(pi.center_clipped)


def test_emission_of_an_empty_frame():
    ps = gt.make_random_scene(50, seed=0, device="cpu")
    _, pcam, _ = both_cameras(160, 128, pos=(0.0, 0.0, -50.0))
    ps = ps._replace(positions=ps.positions + 200.0)  # all behind/outside
    proj = gt.preprocess_gaussians(
        ps, pcam, width=160, height=128, tile_w=32, tile_h=32, tiles_x=5, tiles_y=4
    )
    inst = gt.build_packed_instances(
        proj, tiles_x=5, tiles_y=4, tile_w=32, tile_h=32, near=pcam.near, far=pcam.far
    )
    assert int(inst.total_instances) == 0
    assert inst.packed_feats.shape == (5, 0)
    assert int(inst.tile_count.sum()) == 0 and inst.tile_start.shape == (20,)


def test_pack_key_and_sort_packed_match():
    rng = np.random.default_rng(0)
    tiles = rng.integers(0, 2040, 5000).astype(np.int32)
    depth = rng.integers(0, 1 << 21, 5000).astype(np.uint32)
    depth[:100] = depth[100:200]
    tiles[:100] = tiles[100:200]
    want = np.asarray(jax_sort.pack_key(tiles, depth, 21))
    got = gt.pack_key(torch.from_numpy(tiles), torch.from_numpy(depth.astype(np.int64)), 21)
    np.testing.assert_array_equal(want, got.numpy().astype(np.uint32))
    payload = np.arange(5000, dtype=np.uint32)
    jk, jp = jax_sort.sort_packed(want, payload)
    pk, pp = gt.sort_packed(got, torch.from_numpy(payload.astype(np.int64))[None, :])
    np.testing.assert_array_equal(np.asarray(jk), pk.numpy().astype(np.uint32))
    # Stable: ties keep their input order, like the JAX stable sort.
    np.testing.assert_array_equal(np.asarray(jp), pp[0].numpy().astype(np.uint32))

