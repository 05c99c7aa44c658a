"""The compositor's saturation census (``with_sat``) against the JAX
package's Pallas compositor.

Both compositors get the same packed records: the JAX package's own
``build_packed_instances`` output, carried across as NumPy. The JAX
compositor runs in interpret mode with ``mxu_q=False``, the direct
quadratic the port uses. ``sat_idx`` must be equal on every block; the
framebuffer rows stay within 1e-3 (the bound test_torch_compositor.py
states). The cases cover partial tiles (blocks wholly or partly past the
image edge) and the recorded traps of the census: a block with no
in-image pixel records its tile's first walked chunk, and a tile with no
lanes walks one chunk when its start is not chunk-aligned (its off-image
blocks then record start − 1, a lane of the previous tile) and none
when it is.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops.instances import build_packed_instances as jax_build_fn
from gaussianrenderer_tpu.ops.pallas import tile_render2 as jax_tr2
from gaussianrenderer_tpu.ops.projection import preprocess_gaussians as jax_preprocess

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.ops.cuda import tile_render2 as tr2

from test_torch_common import both_cameras, both_configs, both_scenes

MAX_ABS = 1e-3

jax_build = jax.jit(
    jax_build_fn,
    static_argnames=("tiles_x", "tiles_y", "tile_w", "tile_h", "tier_boost", "want_depth"),
)


@functools.lru_cache(maxsize=None)
def jax_records(height, width, n=30000, grid=(0, 0)):
    """The JAX package's packed records of a dense overdraw frame (most
    blocks saturate), as NumPy arrays; ``grid`` is (num_tile_x,
    num_tile_y), (0, 0) for the default 32×32 tiles."""
    js, _ = both_scenes(n, seed=0, extent=2.0, scale_range=(0.02, 0.08))
    jcfg, cfg = both_configs(height=height, width=width, num_tile_x=grid[0],
                             num_tile_y=grid[1])
    jcam, _, _ = both_cameras(width, height, pos=(0.0, 0.0, 2.5), fov=70.0)
    geo = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
               tile_h=cfg.tile_h)
    proj = jax_preprocess(js, jcam, width=width, height=height, **geo)
    ji = jax_build(proj, near=jcam.near, far=jcam.far, tier_boost=3, **geo)
    assert not bool(ji.overflow)
    total = int(ji.total_instances)
    return (np.asarray(ji.packed_feats)[:, :total], np.asarray(ji.tile_start),
            np.asarray(ji.tile_count), cfg)


def both_with_sat(feats, start, count, cfg):
    kw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
              tile_h=cfg.tile_h, width=cfg.width, height=cfg.height,
              chunk=cfg.packed_chunk, out_alpha=True)
    jfb, jsat = jax_tr2.composite_tiles_packed(feats, start, count, mxu_q=False,
                                               with_sat=True, **kw)
    pfb, psat = gt.composite_tiles_packed(
        torch.from_numpy(feats.view(np.int32).copy()), torch.from_numpy(start.copy()),
        torch.from_numpy(count.copy()), with_sat=True, **kw,
    )
    return np.asarray(jfb), np.asarray(jsat), pfb.numpy(), psat.numpy()


def off_image_blocks(cfg, tile):
    """Mask over a tile's (by, bx) blocks: True where the block has no
    in-image pixel."""
    bw, bh = cfg.tile_w // 16, cfg.tile_h // 16
    x0 = (tile % cfg.tiles_x) * cfg.tile_w
    y0 = (tile // cfg.tiles_x) * cfg.tile_h
    by, bx = np.divmod(np.arange(bw * bh), bw)
    return (x0 + bx * 16 >= cfg.width) | (y0 + by * 16 >= cfg.height)


@pytest.mark.parametrize("size", [(96, 160), (100, 150)])
def test_sat_idx_matches_jax(size):
    feats, start, count, cfg = jax_records(*size)
    jfb, jsat, pfb, psat = both_with_sat(feats, start, count, cfg)
    nb = (cfg.tile_w // 16) * (cfg.tile_h // 16)
    assert psat.dtype == np.int32 and psat.shape == (cfg.num_tiles * nb,)
    np.testing.assert_array_equal(psat, jsat)
    assert (psat >= 0).sum() > cfg.num_tiles  # the census saturates real blocks
    assert (psat < 0).any() or size == (96, 160)
    assert np.abs(pfb - jfb).max() <= MAX_ABS
    # with_sat changes nothing else: the framebuffer equals the plain one's.
    plain = tr2.composite_tiles_packed_plain(
        torch.from_numpy(feats.view(np.int32).copy()), torch.from_numpy(start.copy()),
        torch.from_numpy(count.copy()), tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h, width=cfg.width, height=cfg.height,
        chunk=cfg.packed_chunk, out_alpha=True,
    ).numpy()
    np.testing.assert_array_equal(pfb, plain)
    if size == (100, 150):
        # Off-image blocks record their tile's first walked chunk.
        for t in range(cfg.num_tiles):
            off = off_image_blocks(cfg, t)
            k = cfg.packed_chunk
            first = min((start[t] // k + 1) * k, start[t] + count[t]) - 1
            if off.any() and count[t] > 0:
                np.testing.assert_array_equal(psat[t * nb:(t + 1) * nb][off], first)


def test_sat_idx_matches_jax_on_128x128_tiles():
    """Census tiles of 64 blocks (more than one 32-bit mask word); the
    last pixel column of the second tile is past the image."""
    feats, start, count, cfg = jax_records(128, 255, n=20000, grid=(2, 1))
    assert (cfg.tile_w, cfg.tile_h) == (128, 128) and cfg.packed_compatible
    jfb, jsat, pfb, psat = both_with_sat(feats, start, count, cfg)
    assert psat.shape == (cfg.num_tiles * 64,)
    np.testing.assert_array_equal(psat, jsat)
    # Blocks saturate in both 32-block halves of the first tile.
    assert (psat[:32] >= 0).any() and (psat[32:64] >= 0).any() and (psat < 0).any()
    assert np.abs(pfb - jfb).max() <= MAX_ABS


def test_sat_idx_of_empty_tiles_matches_jax():
    """Zero-count tiles in the partial last row: one at a start that is
    not chunk-aligned (walks one chunk; its off-image blocks record
    start − 1, its in-image blocks never saturate) and one at an aligned
    start (walks none; every block stays −1)."""
    feats, start, count, cfg = jax_records(100, 150)
    start, count = start.copy(), count.copy()
    k = cfg.packed_chunk
    last_row = cfg.num_tiles - cfg.tiles_x
    unaligned, aligned = last_row, last_row + 1
    start[unaligned], count[unaligned] = start[unaligned] + 37, 0
    assert start[unaligned] % k != 0
    start[aligned], count[aligned] = k, 0
    jfb, jsat, pfb, psat = both_with_sat(feats, start, count, cfg)
    np.testing.assert_array_equal(psat, jsat)
    assert np.abs(pfb - jfb).max() <= MAX_ABS
    nb = (cfg.tile_w // 16) * (cfg.tile_h // 16)
    off = off_image_blocks(cfg, unaligned)
    assert off.any() and (~off).any()
    got = psat[unaligned * nb:(unaligned + 1) * nb]
    np.testing.assert_array_equal(got[off], start[unaligned] - 1)
    np.testing.assert_array_equal(got[~off], -1)
    np.testing.assert_array_equal(psat[aligned * nb:(aligned + 1) * nb], -1)
