"""The port's ``ops/satcull.py`` against the JAX package's, function by
function, plus the properties ``tests/test_satcull.py`` pins for the JAX
package (a conservative pyramid on both lookup paths; the initial state
never culls).

Every comparison is bit-exact: the functions are integer index
arithmetic, maxes, gathers and the same f32 expressions in the same
order. The JAX functions run op by op here (no jit), as the port does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops import satcull as jsat
from gaussianrenderer_tpu.ops.instances import build_packed_instances as jax_build_fn
from gaussianrenderer_tpu.ops.projection import ProjectedGaussians as JaxProjected

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.ops import satcull as psat

from test_torch_common import both_cameras, both_configs, both_scenes

from test_torch_instances import assert_records_match, per_tile_records


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _cutoff_img(rng, sy, sx, unsat=0.2):
    """A seeded cutoff image: depths in [0.2, 100) with a share of
    unsaturated (SAT_NONE) blocks."""
    img = rng.uniform(0.2, 100.0, (sy, sx)).astype(np.float32)
    img[rng.random((sy, sx)) < unsat] = psat.SAT_NONE
    return img


def _rects(rng, n, sx, sy, spill=40):
    """(N, 4) f32 pixel AABBs, some reaching past the grid on each side."""
    x0 = rng.uniform(-spill, sx * 16 + spill, n)
    y0 = rng.uniform(-spill, sy * 16 + spill, n)
    x1 = x0 + rng.exponential(60.0, n)
    y1 = y0 + rng.exponential(60.0, n)
    return np.stack([x0, y0, x1, y1], 1).astype(np.float32)


@pytest.mark.parametrize("grid", [(4, 3, 32, 32), (60, 34, 32, 32), (8, 6, 16, 16),
                                  (5, 4, 64, 32)])
def test_geometry_matches(grid):
    tx, ty, tw, th = grid
    sy, sx = psat.sat_grid(tx, ty, tw, th)
    assert (sy, sx) == jsat.sat_grid(tx, ty, tw, th)
    assert psat._levels(sx, sy) == [tuple(lv) for lv in jsat._levels(sx, sy)]
    assert psat.table_size(sx, sy) == jsat.table_size(sx, sy)
    init = psat.initial_cutoff(tx, ty, tw, th, device="cpu")
    np.testing.assert_array_equal(init.numpy(), np.asarray(jsat.initial_cutoff(tx, ty, tw, th)))
    assert psat.SAT_NONE == float(jsat.SAT_NONE) and psat.SB == jsat.SB


@pytest.mark.parametrize("shape", [(68, 120), (5, 7), (1, 1), (1, 9), (135, 240)])
def test_build_pyramid_and_dilate_bit_equal(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    img = _cutoff_img(rng, *shape)
    want = np.asarray(jsat.build_pyramid(jnp.asarray(img)))
    got = psat.build_pyramid(_t(img))
    assert got.shape == (psat.table_size(shape[1], shape[0]),)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    for radius in (0, 1, 2):
        np.testing.assert_array_equal(
            _bits(psat.dilate_cutoff(_t(img), radius).numpy()),
            _bits(jsat.dilate_cutoff(jnp.asarray(img), radius)),
        )


@pytest.mark.parametrize("use_lookup", [True, False])
@pytest.mark.parametrize("shape", [(34, 60), (135, 240)])
def test_rect_cutoff_and_cull_mask_bit_equal(shape, use_lookup):
    """Both lookup paths: the bf16-ceiled table through ``table_lookup``
    (the TPU kernel in interpret mode on the JAX side), and the plain
    gather of the unrounded table (``use_pallas=False``). (135, 240) is
    the 4K grid, whose pyramid exceeds 16,384 entries."""
    sy, sx = shape
    rng = np.random.default_rng(sx)
    img = _cutoff_img(rng, sy, sx)
    table = np.asarray(jsat.build_pyramid(jnp.asarray(img)))
    aabb = _rects(rng, 3000, sx, sy)
    want = np.asarray(jsat.rect_cutoff(jnp.asarray(table), jnp.asarray(aabb), sx=sx, sy=sy,
                                       use_pallas=use_lookup))
    got = psat.rect_cutoff(_t(table), _t(aabb), sx=sx, sy=sy, use_lookup=use_lookup)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    valid = rng.random(3000) < 0.8
    # Depths near the cutoffs, so the threshold decides many splats.
    depth = (want + rng.normal(0.0, 0.5, 3000)).astype(np.float32)
    step = np.float32(99.8 / ((1 << 21) - 1))
    kw = dict(sx=sx, sy=sy, margin=0.25)
    jm = np.asarray(jsat.cull_mask(jnp.asarray(valid), jnp.asarray(depth), jnp.asarray(aabb),
                                   jnp.asarray(table), depth_step=jnp.float32(step),
                                   use_pallas=use_lookup, **kw))
    pm = psat.cull_mask(_t(valid), _t(depth), _t(aabb), _t(table),
                        depth_step=torch.tensor(step), use_lookup=use_lookup, **kw)
    np.testing.assert_array_equal(pm.numpy(), jm)
    assert 0 < jm.sum() < valid.sum()


@pytest.mark.parametrize("tiles", [(4, 3, 32, 32), (60, 34, 32, 32), (8, 6, 16, 32)])
def test_tile_cutoff_q_and_cutoff_from_sat_bit_equal(tiles):
    tx, ty, tw, th = tiles
    sy, sx = psat.sat_grid(tx, ty, tw, th)
    rng = np.random.default_rng(tx * ty)
    img = _cutoff_img(rng, sy, sx)
    for near, far, bits, margin in ((0.2, 100.0, 21, 0.25), (0.3, 100.0, 24, 0.0),
                                    (0.01, 1000.0, 20, 1.5)):
        step = (np.float32(far) - np.float32(near)) / np.float32((1 << bits) - 1)
        kw = dict(tiles_x=tx, tiles_y=ty, tile_w=tw, tile_h=th, margin=margin)
        want = np.asarray(jsat.tile_cutoff_q(jnp.asarray(img), near=jnp.float32(near),
                                             depth_step=jnp.float32(step), **kw))
        got = psat.tile_cutoff_q(_t(img), near=torch.tensor(near, dtype=torch.float32),
                                 depth_step=torch.tensor(step), **kw)
        assert got.shape == (tx * ty,) and got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    nb = (tw // 16) * (th // 16)
    c = 5000
    sat_idx = rng.integers(-1, c, tx * ty * nb).astype(np.int32)
    sat_idx[rng.random(sat_idx.shape) < 0.3] = -1
    depth_sorted = np.sort(rng.uniform(0.2, 100.0, c)).astype(np.float32)
    geo = dict(tiles_x=tx, tiles_y=ty, tile_w=tw, tile_h=th)
    want = np.asarray(jsat.cutoff_from_sat(jnp.asarray(sat_idx), jnp.asarray(depth_sorted),
                                           **geo))
    got = psat.cutoff_from_sat(_t(sat_idx), _t(depth_sorted), **geo)
    assert got.shape == (sy, sx)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # No lanes at all: every block unsaturated.
    empty = psat.cutoff_from_sat(torch.full((tx * ty * nb,), -1, dtype=torch.int32),
                                 torch.zeros(0), **geo)
    assert bool((empty == psat.SAT_NONE).all())


def test_pyramid_sample_is_conservative():
    """``test_pyramid_sample_is_conservative``, ported: a sample never lies
    below the true rect max on the plain path, and the lookup path (bf16
    round-up table) is only looser."""
    rng = np.random.default_rng(2)
    sy, sx = 68, 120
    img = rng.uniform(0.2, 100.0, size=(sy, sx)).astype(np.float32)
    table = psat.build_pyramid(_t(img))
    rects, true_max = [], []
    for _ in range(400):
        x0 = int(rng.integers(0, sx * 16 - 1))
        x1 = int(rng.integers(x0, sx * 16))
        y0 = int(rng.integers(0, sy * 16 - 1))
        y1 = int(rng.integers(y0, sy * 16))
        rects.append([x0, y0, x1, y1])
        true_max.append(img[y0 // 16: y1 // 16 + 1, x0 // 16: x1 // 16 + 1].max())
    rects = _t(np.array(rects, np.float32))
    cut = psat.rect_cutoff(table, rects, sx=sx, sy=sy, use_lookup=False).numpy()
    assert np.all(cut >= np.array(true_max) - 1e-5)
    cut_l = psat.rect_cutoff(table, rects, sx=sx, sy=sy).numpy()
    assert np.all(cut_l >= cut - 1e-5)


@pytest.mark.parametrize("use_lookup", [True, False])
def test_initial_cutoff_never_culls(use_lookup):
    table = psat.build_pyramid(psat.initial_cutoff(4, 3, 32, 32, device="cpu"))
    rng = np.random.default_rng(3)
    aabb = np.stack([rng.uniform(0, 100, 64), rng.uniform(0, 90, 64),
                     rng.uniform(0, 128, 64), rng.uniform(0, 96, 64)], 1)
    mask = psat.cull_mask(
        torch.ones(64, dtype=torch.bool), torch.full((64,), 99.0),
        _t(aabb.astype(np.float32)), table, sx=8, sy=6, margin=0.0,
        depth_step=1e-4, use_lookup=use_lookup,
    )
    assert not bool(mask.any())


jax_build = jax.jit(
    jax_build_fn,
    static_argnames=("tiles_x", "tiles_y", "tile_w", "tile_h", "tier_boost", "want_depth"),
)


def test_emission_with_sat_cut_q_matches():
    """``build_packed_instances(sat_cut_q=...)`` on a seeded per-tile cutoff
    table: the totals, the per-tile multisets of (depth_q, 5 rows) and
    the effective-lane histogram equal the JAX emitter's. The table puts
    cutoffs inside the splats' depth range, so the per-position cull
    drops a real share of the (splat, tile) pairs, from rects of every
    size."""
    _, ps = both_scenes(2500, seed=4, scale_range=(0.01, 0.3))
    _, cfg = both_configs(height=128, width=160)
    jcam, pcam, _ = both_cameras(cfg.width, cfg.height)
    proj = gt.preprocess_gaussians(
        ps, pcam, width=cfg.width, height=cfg.height, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
    )
    geo = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
               tile_h=cfg.tile_h)
    num_tiles = cfg.num_tiles
    depth_bits = min(32 - num_tiles.bit_length(), 24)
    rng = np.random.default_rng(5)
    d = proj.depth[proj.valid].numpy()
    q_cut = (np.quantile(d, rng.uniform(0.1, 0.9, num_tiles)) - 0.2) / 99.8
    table = psat.bf16_ceil(torch.from_numpy(
        (q_cut * ((1 << depth_bits) - 1)).astype(np.float32))).numpy()
    table[:3] = np.float32(3.0e38)  # a few tiles never cull
    ji = jax_build(JaxProjected(*(f.numpy() for f in proj)), near=jcam.near, far=jcam.far,
                   tier_boost=3, want_depth=True, sat_cut_q=jnp.asarray(table), **geo)
    pi = gt.build_packed_instances(proj, near=pcam.near, far=pcam.far, want_depth=True,
                                   sat_cut_q=_t(table), **geo)
    full = gt.build_packed_instances(proj, near=pcam.near, far=pcam.far, **geo)
    assert not bool(ji.overflow)
    total = int(ji.total_instances)
    assert int(pi.total_instances) == total
    assert 0.2 * int(full.total_instances) < total < 0.9 * int(full.total_instances)
    start, count = np.asarray(ji.tile_start), np.asarray(ji.tile_count)
    np.testing.assert_array_equal(start, pi.tile_start.numpy())
    np.testing.assert_array_equal(count, pi.tile_count.numpy())
    np.testing.assert_array_equal(np.asarray(ji.area_hist), pi.area_hist.numpy())
    assert not np.array_equal(np.asarray(ji.area_hist), full.area_hist.numpy())
    jdep = np.asarray(ji.depth_f32)[:total]
    pdep = pi.depth_f32.numpy()
    # The decode follows the jitted JAX arithmetic, so depths are bit-equal.
    np.testing.assert_array_equal(np.sort(pdep), np.sort(jdep))
    # As in test_torch_instances.py: jitted XLA may move a needle splat's
    # chol-w code by one (an FMA in C − v²); every other field is exact.
    assert_records_match(
        per_tile_records(np.asarray(ji.packed_feats)[:, :total], jdep, start, count,
                         num_tiles),
        per_tile_records(pi.packed_feats.numpy().view(np.uint32), pdep, start, count,
                         num_tiles),
        w_codes=1,
    )
