"""Per-tile front-to-back alpha compositing on f32 features (PyTorch port
of ``ops/compositing.py``).

Each Gaussian becomes one 16-float feature row (``build_features``);
rows are gathered into sorted instance order (``gather_sorted_features``
and, on the training path, ``gather_sorted_features_seg``), and every
tile composites its instance range in chunks of K lanes:

  * alpha = min(op · exp(−½·md²), 0.99), zeroed outside the pixel AABB,
    below 1e-3 and past the tile's range;
  * within a chunk, T before each lane is T_carry times the exclusive
    product of (1 − alpha); a lane's weight alpha·T counts while that T
    is ≥ 1e-3;
  * across chunks the carry freezes at the stop: T_carry ·= the product
    of (1 − alpha) over the gated lanes.

``composite_tiles_xla`` leaves a tile once no pixel has T ≥ 1e-3;
``composite_tiles_diff`` is the differentiable form (torch autograd), a
fixed walk truncated at ``max_chunks`` chunks per tile with the md² clip
that keeps exp and its gradient finite. Colour sums are fp32 matrix
products, which run in full fp32 unless the caller turns TF32 on.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from gaussianrenderer_tpu_torch.ops.cuda.segment_sum import segment_sum_ordered
from gaussianrenderer_tpu_torch.ops.projection import ProjectedGaussians
from gaussianrenderer_tpu_torch.ops.tiling import TileAssignment

#: Feature-row layout: one 16-float row per Gaussian.
FEAT_CX = 0
FEAT_CY = 1
FEAT_CONIC_A = 2
FEAT_CONIC_B = 3
FEAT_CONIC_C = 4
FEAT_OPACITY = 5
FEAT_R = 6
FEAT_G = 7
FEAT_B = 8
FEAT_XMIN = 9
FEAT_YMIN = 10
FEAT_XMAX = 11
FEAT_YMAX = 12
FEAT_DEPTH = 13  # camera-space depth (expected-depth output)
FEAT_DIM = 16

ALPHA_EPS = 1e-3
T_EPS = 1e-3
ALPHA_MAX = 0.99
#: Clip of md² on the differentiable path (exp and its gradient stay finite).
MD2_CLIP = 80.0


def build_features(proj: ProjectedGaussians) -> torch.Tensor:
    """Pack per-Gaussian render fields into an (N, 16) float32 matrix;
    invalid Gaussians get opacity 0 so they can never contribute."""
    n = proj.depth.shape[0]
    f32 = torch.float32
    cols = torch.cat(
        [
            proj.center_px.to(f32),
            proj.conic.to(f32),
            torch.where(proj.valid, proj.opacity, 0.0)[:, None].to(f32),
            proj.color.to(f32),
            proj.aabb_px.to(f32),
            proj.depth[:, None].to(f32),
        ],
        dim=-1,
    )
    pad = torch.zeros((n, FEAT_DIM - cols.shape[1]), dtype=f32, device=cols.device)
    return torch.cat([cols, pad], dim=-1)


def _pad_chunk(sorted_feats: torch.Tensor, chunk_size: int) -> torch.Tensor:
    pad = sorted_feats.new_zeros((chunk_size, FEAT_DIM))
    return torch.cat([sorted_feats, pad], dim=0)


def gather_sorted_features(
    feats: torch.Tensor, assignment: TileAssignment, chunk_size: int
) -> torch.Tensor:
    """Features in sorted-instance order, padded by one all-zero chunk
    (opacity 0: no contribution): (C + K, 16)."""
    return _pad_chunk(feats[assignment.gaussian_id.to(torch.int64)], chunk_size)


class _GatherRowsSeg(torch.autograd.Function):
    """``feats[ids]`` whose backward sums each Gaussian's instance rows
    in their sorted order: the rows ``order[offsets[s]:offsets[s + 1]]``
    of Gaussian ``s`` (``ops/cuda/segment_sum.py``)."""

    @staticmethod
    def forward(ctx, feats, ids, order, offsets):
        ctx.save_for_backward(order, offsets)
        return feats[ids]

    @staticmethod
    def backward(ctx, d):
        order, offsets = ctx.saved_tensors
        return segment_sum_ordered(d.contiguous(), order, offsets), None, None, None


def gather_sorted_features_seg(
    feats: torch.Tensor, assignment: TileAssignment, chunk_size: int
) -> torch.Tensor:
    """:func:`gather_sorted_features` with the training path's gradient:
    per-Gaussian sums of the (C, 16) cotangent rows.

    The JAX package sums them by a sort keyed on gaussian id and a
    cumsum, each segment a difference of two prefixes, because
    scatter-add is serial on the TPU. The port adds each Gaussian's rows
    directly, in their sorted (tile, depth) order, with one fixed order
    on the card (no float atomics): a step gives the same gradient every
    time, and on the CPU the same bits as ``index_add_``. As in the JAX
    package, the emission locates the segments: the assignment's
    ``segment_start`` bounds each Gaussian's emitted slots and
    ``segment_slot`` gives each slot's sorted row, in rising order (the
    stable argsort of ``gaussian_id``, which the backward need not
    compute)."""
    if assignment.segment_start.shape[0] != feats.shape[0] + 1:
        raise ValueError(
            f"gather: {feats.shape[0]} feature rows, but the assignment's segments "
            f"cover {assignment.segment_start.shape[0] - 1} Gaussians")
    rows = _GatherRowsSeg.apply(feats, assignment.gaussian_id.to(torch.int64),
                                assignment.segment_slot, assignment.segment_start)
    return _pad_chunk(rows, chunk_size)


def _tile_pixels(tiles_x: int, tiles_y: int, tile_w: int, tile_h: int, device):
    """Global pixel coordinates of every tile's pixels: (T, P) x and y."""
    t = torch.arange(tiles_x * tiles_y, device=device)
    p = torch.arange(tile_w * tile_h, device=device)
    gx = ((t % tiles_x) * tile_w)[:, None] + (p % tile_w)[None, :]
    gy = ((t // tiles_x) * tile_h)[:, None] + (p // tile_w)[None, :]
    return gx.to(torch.float32), gy.to(torch.float32)


def _chunk_alpha(feats, k_valid, gx, gy, clip_md2: bool):
    """Masked alpha of a (T, K, 16) feature chunk over (T, P) pixels:
    (T, P, K)."""
    def col(j):
        return feats[:, None, :, j]  # (T, 1, K)

    dx = gx[:, :, None] - col(FEAT_CX)
    dy = gy[:, :, None] - col(FEAT_CY)
    md2 = col(FEAT_CONIC_A) * dx * dx + col(FEAT_CONIC_B) * dx * dy + (
        col(FEAT_CONIC_C) * dy * dy
    )
    if clip_md2:
        md2 = torch.clamp(md2, 0.0, MD2_CLIP)
    alpha = torch.clamp_max(col(FEAT_OPACITY) * torch.exp(-0.5 * md2), ALPHA_MAX)
    px, py = gx[:, :, None], gy[:, :, None]
    inside = (
        (px >= col(FEAT_XMIN)) & (px <= col(FEAT_XMAX))
        & (py >= col(FEAT_YMIN)) & (py <= col(FEAT_YMAX))
    )
    return torch.where(
        inside & (alpha >= ALPHA_EPS) & k_valid[:, None, :], alpha, 0.0
    )


def _chunk_blend(alpha, feats, transmittance, acc, with_depth: bool):
    """Blend one chunk's (T, P, K) alphas into the (T, P, ch) sums;
    returns (t_before, gate, u) too for the carry update."""
    one_minus = 1.0 - alpha
    u = torch.cumprod(one_minus, dim=2)
    u_excl = torch.cat([torch.ones_like(u[:, :, :1]), u[:, :, :-1]], dim=2)
    t_before = transmittance[:, :, None] * u_excl
    gate = t_before >= T_EPS
    weights = torch.where(gate, alpha * t_before, 0.0)
    cols = feats[:, :, FEAT_R:FEAT_B + 1]
    if with_depth:
        cols = torch.cat([cols, feats[:, :, FEAT_DEPTH:FEAT_DEPTH + 1]], dim=2)
    acc = acc + torch.bmm(weights, cols)  # (T, P, ch)
    return acc, gate, u, one_minus


def composite_chunk(
    feats: torch.Tensor,  # (T, K, 16)
    k_valid: torch.Tensor,  # (T, K) bool — slot within its tile's count
    gx: torch.Tensor,  # (T, P)
    gy: torch.Tensor,  # (T, P)
    transmittance: torch.Tensor,  # (T, P)
    acc: torch.Tensor,  # (T, P, 3 | 4): rgb [+ depth]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite one chunk of K sorted instances of each tile over its
    P pixels; returns the new (transmittance, acc). ``acc`` with four
    channels also accumulates the expected depth Σ w·d. (The JAX version
    takes one tile; here tiles are a leading batch dimension.)"""
    alpha = _chunk_alpha(feats, k_valid, gx, gy, clip_md2=False)
    acc, gate, _, one_minus = _chunk_blend(
        alpha, feats, transmittance, acc, acc.shape[2] == 4
    )
    transmittance = transmittance * torch.prod(
        torch.where(gate, one_minus, 1.0), dim=2
    )
    return transmittance, acc


def _chunk_feats(sorted_feats, start, i, k):
    """(T, K, 16) rows ``start + i·K + [0, K)`` of each tile, clamped into
    the array (rows past a tile's count are masked by the caller)."""
    lane = torch.arange(k, device=start.device)
    idx = start[:, None].to(torch.int64) + i * k + lane[None, :]
    return sorted_feats[torch.clamp(idx, 0, sorted_feats.shape[0] - 1)]


def _assemble(rows, *, tiles_x, tiles_y, tile_w, tile_h, width, height):
    """(nc, T, P) tile rows → (nc, height, width) framebuffer."""
    nc = rows.shape[0]
    fb = rows.reshape(nc, tiles_y, tiles_x, tile_h, tile_w)
    fb = fb.permute(0, 1, 3, 2, 4).reshape(nc, tiles_y * tile_h, tiles_x * tile_w)
    return fb[:, :height, :width]


def composite_tiles_xla(
    sorted_feats: torch.Tensor,  # (C + K, 16)
    tile_start: torch.Tensor,  # (T,)
    tile_count: torch.Tensor,  # (T,)
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    width: int,
    height: int,
    chunk_size: int,
    return_alpha: bool = False,
    return_depth: bool = False,
) -> torch.Tensor:
    """Composite every tile; returns a planar (3, H, W) framebuffer with
    optional extra rows [alpha (1 − T_final)] [expected depth Σ w·d].

    Each tile walks chunks at ``start + i·K`` while ``i·K < count`` and
    some pixel still has T ≥ 1e-3 (the JAX package's early exit)."""
    dev = sorted_feats.device
    k = chunk_size
    gx, gy = _tile_pixels(tiles_x, tiles_y, tile_w, tile_h, dev)
    num_tiles, p = gx.shape
    count = tile_count.to(torch.int64)
    lane = torch.arange(k, device=dev)
    trans = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    acc = torch.zeros((num_tiles, p, 3 + int(return_depth)), dtype=torch.float32,
                      device=dev)
    active = count > 0
    i = 0
    while bool(active.any()):
        feats = _chunk_feats(sorted_feats, tile_start, i, k)
        k_valid = ((i * k + lane)[None, :] < count[:, None]) & active[:, None]
        trans_new, acc = composite_chunk(feats, k_valid, gx, gy, trans, acc)
        trans = torch.where(active[:, None], trans_new, trans)
        i += 1
        active = active & (i * k < count) & (trans.amax(1) >= T_EPS)
    rows = [acc[:, :, 0], acc[:, :, 1], acc[:, :, 2]]
    if return_alpha:
        rows.append(1.0 - trans)
    if return_depth:
        rows.append(acc[:, :, 3])
    return _assemble(torch.stack(rows, 0), tiles_x=tiles_x, tiles_y=tiles_y,
                     tile_w=tile_w, tile_h=tile_h, width=width, height=height)


def _diff_chunk(transmittance, acc, feats, k_valid, gx, gy):
    alpha = _chunk_alpha(feats, k_valid, gx, gy, clip_md2=True)
    acc, gate, u, _ = _chunk_blend(alpha, feats, transmittance, acc, acc.shape[2] == 4)
    transmittance = transmittance * torch.amin(torch.where(gate, u, 1.0), dim=2)
    return transmittance, acc


def composite_tiles_diff(
    sorted_feats: torch.Tensor,  # (C + K, 16)
    tile_start: torch.Tensor,  # (T,)
    tile_count: torch.Tensor,  # (T,)
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    width: int,
    height: int,
    chunk_size: int,
    max_chunks: int = 32,
    return_alpha: bool = False,
    return_depth: bool = False,
) -> torch.Tensor:
    """Differentiable compositor (torch autograd): the chunk math of
    :func:`composite_tiles_xla` with no early exit, each tile truncated
    at ``max_chunks·chunk_size`` lanes, md² clipped to [0, 80], and the
    gated carry T·min(where(gate, u, 1)).

    Chunks past every tile's count change nothing, so the walk stops
    there. Each chunk is recomputed in the backward pass
    (``torch.utils.checkpoint``), so autograd keeps one chunk's
    intermediates at a time."""
    dev = sorted_feats.device
    k = chunk_size
    gx, gy = _tile_pixels(tiles_x, tiles_y, tile_w, tile_h, dev)
    num_tiles, p = gx.shape
    count = tile_count.to(torch.int64)
    lane = torch.arange(k, device=dev)
    n_chunks = min(max_chunks, -(-int(count.max()) // k)) if num_tiles else 0
    trans = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    acc = torch.zeros((num_tiles, p, 3 + int(return_depth)), dtype=torch.float32,
                      device=dev)
    for i in range(n_chunks):
        feats = _chunk_feats(sorted_feats, tile_start, i, k)
        k_valid = (i * k + lane)[None, :] < count[:, None]
        if torch.is_grad_enabled() and sorted_feats.requires_grad:
            trans, acc = checkpoint(_diff_chunk, trans, acc, feats, k_valid, gx, gy,
                                    use_reentrant=False)
        else:
            trans, acc = _diff_chunk(trans, acc, feats, k_valid, gx, gy)
    rows = [acc[:, :, 0], acc[:, :, 1], acc[:, :, 2]]
    if return_alpha:
        rows.append(1.0 - trans)
    if return_depth:
        rows.append(acc[:, :, 3])
    return _assemble(torch.stack(rows, 0), tiles_x=tiles_x, tiles_y=tiles_y,
                     tile_w=tile_w, tile_h=tile_h, width=width, height=height)
