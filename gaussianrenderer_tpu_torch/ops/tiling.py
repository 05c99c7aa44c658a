"""Tile-instance expansion, (tile, depth) key sort and per-tile ranges for
the f32 tile-sort path (PyTorch port of ``ops/tiling.py``).

Every valid splat emits its whole tile rect: one instance per (splat,
tile) pair, gaussian-major and row-major inside the rect, with no
per-position cull (the training path's rule). Instances are keyed
``(tile << depth_bits) | depth_q``, with ``depth_q`` the camera depth
quantized over [near, far] to ``depth_bits = min(32 − bit_length(T), 24)``
bits, and sorted by one stable sort. Because the emission order and the
sort's tie rule are the JAX package's, ``gaussian_id``, ``tile_id``,
``tile_start`` and ``tile_count`` equal its output bit for bit on the
first ``total_instances`` slots.

The assignment also keeps where each Gaussian's instances went, for the
training gather's transpose (``ops/compositing.py``): ``segment_start``
is the emission's exclusive scan (Gaussian ``s`` emitted slots
``[segment_start[s], segment_start[s + 1])``) and ``segment_slot`` the
sorted position of each emitted slot (the inverse of the sort's
permutation). A rect lies inside the grid and is walked row-major, and
all its instances share one depth, so one Gaussian's keys rise in
emission order and its instances keep that order in the sort: its
sorted rows are ``segment_slot[segment_start[s]:segment_start[s + 1]]``
in increasing order, which is what a stable argsort of ``gaussian_id``
and a search of its runs would give, with no second sort.

The JAX package expands into a static capacity buffer (the TPU needs
static shapes) and flags an overflow; here emission is count → scan and
the arrays hold exactly the emitted instances, so nothing is dropped and
``overflow`` is always False.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussianrenderer_tpu_torch.ops.projection import ProjectedGaussians
from gaussianrenderer_tpu_torch.ops.sort import pack_key
from gaussianrenderer_tpu_torch.utils import trace


class TileAssignment(NamedTuple):
    """Sorted (tile, depth) instance list plus per-tile ranges."""

    gaussian_id: torch.Tensor  # (C,) int32 index into the projected arrays
    tile_id: torch.Tensor  # (C,) int32 sorted ascending
    tile_start: torch.Tensor  # (T,) int32 first instance slot of each tile
    tile_count: torch.Tensor  # (T,) int32 instances in each tile
    total_instances: torch.Tensor  # () int64 — instances emitted (== C)
    overflow: torch.Tensor  # () bool — always False: nothing is truncated
    segment_slot: torch.Tensor  # (C,) int32 sorted slot of each emitted instance
    segment_start: torch.Tensor  # (N + 1,) int32 first emitted slot of each Gaussian, then C


def build_sorted_instances(
    proj: ProjectedGaussians,
    *,
    tiles_x: int,
    num_tiles: int,
    capacity: Optional[int] = None,
    depth_scale: float = 1.0e6,
    near=0.1,
    far=100.0,
    depth_bits: Optional[int] = None,
) -> TileAssignment:
    """Expand per-Gaussian tile rects into a sorted instance list.

    ``capacity`` and ``depth_scale`` are accepted for the JAX package's
    call signature and change nothing: there is no static buffer to size,
    and the key is the packed emitter's ``depth_bits`` rule (the JAX
    function ignores ``depth_scale`` too). ``depth_bits`` overrides the
    key's depth width, which by default comes from ``num_tiles``: a
    multi-device strip passes the whole grid's, so that it quantizes depth
    as the single device does.
    """
    del capacity, depth_scale
    device = proj.depth.device
    tile_bits = max(int(num_tiles).bit_length(), 1)
    if depth_bits is None:
        depth_bits = min(32 - tile_bits, 24)
    if tile_bits + depth_bits > 32:
        raise ValueError(f"tile_bits {tile_bits} + depth_bits {depth_bits} > 32")

    i64 = torch.int64
    tmin_x = proj.tile_min[:, 0].to(i64)
    tmin_y = proj.tile_min[:, 1].to(i64)
    rect_w = proj.tile_max[:, 0].to(i64) - tmin_x + 1
    rect_h = proj.tile_max[:, 1].to(i64) - tmin_y + 1
    area = torch.where(proj.valid, rect_w * rect_h, 0)

    f32 = torch.float32
    near_t = torch.as_tensor(near, dtype=f32, device=device)
    far_t = torch.as_tensor(far, dtype=f32, device=device)
    span = torch.clamp_min(far_t - near_t, 1e-6)
    depth01 = torch.clamp((proj.depth.detach() - near_t) / span, 0.0, 1.0)
    depth_q = (depth01 * float((1 << depth_bits) - 1)).to(i64)

    # count → exclusive scan → one instance per rect tile, row-major.
    total = trace.host_read("instances", area.sum())
    if total >= 2**31:
        raise ValueError(f"{total} instances exceed the int32 lane index")
    splat = torch.repeat_interleave(
        torch.arange(area.shape[0], device=device), area, output_size=total
    )
    first = torch.cumsum(area, 0) - area
    pos = torch.arange(total, device=device) - first[splat]
    w = rect_w[splat]
    tile = (tmin_x[splat] + pos % w) + (tmin_y[splat] + pos // w) * tiles_x

    # The stable sort of ops/sort.sort_packed, keeping its permutation.
    key_sorted, perm = torch.sort(pack_key(tile, depth_q[splat], depth_bits), stable=True)
    gauss_sorted = splat[perm]
    segment_slot = torch.empty(total, dtype=torch.int32, device=device)
    segment_slot[perm] = torch.arange(total, dtype=torch.int32, device=device)
    tile_sorted = key_sorted >> depth_bits
    count = torch.bincount(tile_sorted, minlength=num_tiles)
    start = torch.cumsum(count, 0) - count
    return TileAssignment(
        gaussian_id=gauss_sorted.to(torch.int32),
        tile_id=tile_sorted.to(torch.int32),
        tile_start=start.to(torch.int32),
        tile_count=count.to(torch.int32),
        total_instances=torch.tensor(total, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
        segment_slot=segment_slot,
        segment_start=torch.cat([first, first.new_full((1,), total)]).to(torch.int32),
    )
