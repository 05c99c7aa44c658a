"""Saturation cull: drop splats provably behind last frame's opaque pixels.

Counterpart of ``gaussianrenderer_tpu/ops/satcull.py``, function by
function. The compositor records, per 16×16 pixel block, the sorted-lane
index at which the block's max transmittance over its in-image pixels
first fell below 1e-3 (``composite_tiles_packed(..., with_sat=True)``);
:func:`cutoff_from_sat` turns that into a per-block cutoff depth. Next
frame a splat is culled when its depth lies beyond the cutoff of every
block its pixel AABB touches, read as one sample of a dilated max
pyramid (:func:`build_pyramid`, :func:`rect_cutoff`), and instances of
the surviving splats are culled per tile inside emission against
:func:`tile_cutoff_q`. The test only ever under-culls: cutoffs round up,
the pyramid over-estimates a rect's max, and :func:`dilate_cutoff`
absorbs lateral motion of the fronts.

Only the lookups are a kernel (``ops/cuda/lookup.py``); the pyramid, the
dilation and the small ``cutoff_from_sat`` gather are plain torch ops,
as they are plain XLA in the JAX package. The f32 arithmetic follows the
JAX package's order, so both give bit-equal cutoffs.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from gaussianrenderer_tpu_torch._device import resolve_device
from gaussianrenderer_tpu_torch.ops.cuda.lookup import bf16_ceil, table_lookup
from gaussianrenderer_tpu_torch.ops.projection import to_int32

#: "Not saturated": a large bf16-exact finite cutoff (2^30), far beyond
#: any camera depth.
SAT_NONE = float(2.0**30)

#: Sub-block edge in pixels (both axes).
SB = 16


def sat_grid(tiles_x: int, tiles_y: int, tile_w: int, tile_h: int) -> Tuple[int, int]:
    """(sy, sx) sub-block grid dims covering the padded tile area."""
    if tile_w % SB or tile_h % SB:
        raise ValueError(f"tile {tile_w}x{tile_h} not divisible by the {SB}px sat block")
    return tiles_y * (tile_h // SB), tiles_x * (tile_w // SB)


def initial_cutoff(
    tiles_x: int, tiles_y: int, tile_w: int, tile_h: int, device="cuda"
) -> torch.Tensor:
    """The no-information state: every block unsaturated (no culling)."""
    sy, sx = sat_grid(tiles_x, tiles_y, tile_w, tile_h)
    return torch.full((sy, sx), SAT_NONE, dtype=torch.float32,
                      device=resolve_device(device))


class _Level(NamedTuple):
    off: int  # flat offset of this level in the concatenated table
    w: int
    h: int


def _levels(sx: int, sy: int) -> List[_Level]:
    """Pyramid geometry: level l cells cover 2^l sub-blocks; the top
    level's cell covers any in-grid span (2^top ≥ max(sx, sy))."""
    top = max(int(math.ceil(math.log2(max(sx, sy)))), 0)
    levels = []
    off, w, h = 0, sx, sy
    for _ in range(top + 1):
        levels.append(_Level(off, w, h))
        off += w * h
        w = -(-w // 2)
        h = -(-h // 2)
    return levels


def table_size(sx: int, sy: int) -> int:
    lv = _levels(sx, sy)
    return lv[-1].off + lv[-1].w * lv[-1].h


def _max2(img: torch.Tensor, stride: int) -> torch.Tensor:
    """Max over each 2×2 window of ``img`` zero-padded by one row and
    column at the bottom/right (stride 1: the forward-window dilation;
    stride 2: the 2× downsample, padding only odd edges)."""
    h, w = img.shape
    pad = (0, 1, 0, 1) if stride == 1 else (0, w % 2, 0, h % 2)
    padded = torch.nn.functional.pad(img, pad)[None, None]
    return torch.nn.functional.max_pool2d(padded, 2, stride=stride)[0, 0]


def build_pyramid(cutoff_img: torch.Tensor) -> torch.Tensor:
    """Cutoff image (sy, sx) → flat dilated-max pyramid (table_size,).

    Level l stores max of L_l over [i, i+1]×[j, j+1], so one sample at
    (y0 >> l, x0 >> l) on a level with 2^l ≥ the rect span covers the
    whole rect (over-estimated, so conservative). Edges pad with 0. Each
    level is two max-pools, so the pyramid costs a few launches a level."""
    sy, sx = cutoff_img.shape
    tabs = []
    cur = cutoff_img
    for _ in _levels(sx, sy):
        tabs.append(_max2(cur, 1).reshape(-1))
        cur = _max2(cur, 2)
    return torch.cat(tabs)


def rect_cutoff(
    table: torch.Tensor,
    aabb_px: torch.Tensor,
    *,
    sx: int,
    sy: int,
    use_lookup: bool = True,
) -> torch.Tensor:
    """Per-splat conservative max cutoff over the sub-blocks its pixel
    AABB ((N, 4) f32 xmin, ymin, xmax, ymax) touches: one pyramid sample
    each. ``use_lookup`` reads it through :func:`table_lookup` on the
    bf16-ceiled table (the JAX package's production path); without it,
    a plain gather of the unrounded f32 table."""
    # (x0, y0, x1, y1) block coordinates, clipped to the grid.
    blk = torch.clamp_min(to_int32(aabb_px) // SB, 0)
    x0, x1 = blk[:, 0].clamp_max(sx - 1), blk[:, 2].clamp_max(sx - 1)
    y0, y1 = blk[:, 1].clamp_max(sy - 1), blk[:, 3].clamp_max(sy - 1)
    span = torch.maximum(x1 - x0, y1 - y0) + 1
    # Level: the number of t < top with span > 2^t (the first level whose
    # cells cover the span), then that level's cell index. The per-level
    # tables are made on the device: a host-built tensor would be copied
    # over, which waits for the device every frame.
    lv = torch.arange(len(_levels(sx, sy)), dtype=torch.int32, device=aabb_px.device)
    width = (torch.full_like(lv, sx - 1) >> lv) + 1  # ceil(sx / 2^l)
    cells = width * ((torch.full_like(lv, sy - 1) >> lv) + 1)
    off = torch.cumsum(cells, 0, dtype=torch.int32) - cells
    lsel = torch.bucketize(span, torch.ones_like(lv[:-1]) << lv[:-1], out_int32=True)
    idx = off[lsel] + (y0 >> lsel) * width[lsel] + (x0 >> lsel)
    if use_lookup:
        m = table.shape[0]
        r = 128 * max(-(-m // 16384), 1)
        return table_lookup(bf16_ceil(table), idx, r=r, q=128)
    return table[idx.to(torch.int64)]


def cull_mask(
    valid: torch.Tensor,
    depth: torch.Tensor,
    aabb_px: torch.Tensor,
    cutoff_table: torch.Tensor,
    *,
    sx: int,
    sy: int,
    margin: float,
    depth_step,
    use_lookup: bool = True,
) -> torch.Tensor:
    """True where the splat is provably (frame-coherently) dead: its depth
    lies beyond its rect's cutoff plus ``margin`` (camera motion) and 1.5
    depth-quantization steps (lane-granular cutoffs vs depth ties)."""
    cut = rect_cutoff(cutoff_table, aabb_px, sx=sx, sy=sy, use_lookup=use_lookup)
    return valid & (depth > cut + (margin + 1.5 * depth_step))


def dilate_cutoff(cutoff_img: torch.Tensor, radius: int) -> torch.Tensor:
    """Max-filter over a (2r+1)² block neighborhood (SAT_NONE past the
    edges): raises every cutoff to its neighbors' so the cull survives up
    to ``radius`` blocks of lateral front motion per frame. One max-pool
    where the JAX package takes r separable 3-point passes: a max is
    exact in any order."""
    if radius <= 0:
        return cutoff_img
    padded = torch.nn.functional.pad(cutoff_img, (radius,) * 4, value=SAT_NONE)
    return torch.nn.functional.max_pool2d(padded[None, None], 2 * radius + 1,
                                          stride=1)[0, 0]


def tile_cutoff_q(
    cutoff_img: torch.Tensor,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    near,
    depth_step,
    margin: float,
) -> torch.Tensor:
    """Per-tile cutoff in depth-quantization units, the table of the
    per-position cull inside emission: an instance at tile t with
    quantized depth q is dead iff q > table[t]. The tile's cutoff is the
    max over its blocks, plus ceil(margin / step), rounded up to bf16."""
    dev = cutoff_img.device
    f32 = torch.float32
    bh = tile_h // SB
    bw = tile_w // SB
    tmax = cutoff_img.reshape(tiles_y, bh, tiles_x, bw).amax(dim=(1, 3))
    step = torch.clamp_min(torch.as_tensor(depth_step, dtype=f32, device=dev), 1e-20)
    q = torch.floor((tmax.reshape(-1) - torch.as_tensor(near, dtype=f32, device=dev)) / step)
    margin_q = torch.ceil(torch.full_like(step, margin) / step)
    return bf16_ceil(q + margin_q)


def cutoff_from_sat(
    sat_idx: torch.Tensor,
    depth_sorted: torch.Tensor,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
) -> torch.Tensor:
    """Compositor sat-lane indices ((T·B,) int32, −1 = never saturated,
    blocks (by, bx) row-major in a tile) → the (sy, sx) cutoff-depth
    image; unsaturated blocks get SAT_NONE."""
    bw = tile_w // SB
    bh = tile_h // SB
    c = depth_sorted.shape[0]
    if c == 0:
        cut = torch.full(sat_idx.shape, SAT_NONE, dtype=torch.float32,
                         device=sat_idx.device)
    else:
        idx = torch.clamp(sat_idx.to(torch.int64), 0, c - 1)
        cut = torch.where(sat_idx >= 0, depth_sorted[idx], SAT_NONE)
    img = cut.reshape(tiles_y, tiles_x, bh, bw)
    return img.permute(0, 2, 1, 3).reshape(tiles_y * bh, tiles_x * bw)
