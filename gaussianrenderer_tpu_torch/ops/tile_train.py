"""Differentiable training compositor: forward kernel + hand-written
backward kernel as one ``torch.autograd.Function`` (PyTorch port of
``ops/pallas/tile_train.py``).

The forward composites every tile's full instance range with per-tile
early termination and no ``max_chunks`` truncation, and checkpoints each
walked chunk's entry transmittance; the backward walks the chunks in
reverse from those checkpoints (ops/cuda/tile_train.py has the
arithmetic). Chunk windows are K-aligned, where ``composite_tiles_diff``
slices at ``start + i·K``: the two differ only where the chunk-end freeze
lands, inside the 1e-3 stop envelope.
"""

from __future__ import annotations

import torch

from gaussianrenderer_tpu_torch.ops.compositing import FEAT_DIM, _assemble
from gaussianrenderer_tpu_torch.ops.cuda.tile_train import (  # noqa: F401
    MD2_CLIP,
    STATS_ROWS,
    chunk_offsets,
    train_backward,
    train_forward,
)
from gaussianrenderer_tpu_torch.utils import trace


def train_kernel_compatible(tile_w: int, tile_h: int) -> bool:
    """Tiles the train kernels take: a pixel count that is a multiple of
    128, as in the JAX package (the CUDA kernels walk a tile's pixels in
    groups, so any such count; the plain versions on the CPU take any
    size)."""
    return (tile_w * tile_h) % 128 == 0


class _CompositeTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sorted_feats, tile_start, tile_count, tiles_x, tiles_y, tile_w,
                tile_h, width, height, chunk, return_alpha):
        geom = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h)
        chk_offset, n_chk = chunk_offsets(tile_start, tile_count, chunk)
        stats, chk = train_forward(sorted_feats, tile_start, tile_count, chk_offset,
                                   n_chk, chunk=chunk, **geom)
        ctx.save_for_backward(sorted_feats, tile_start, tile_count, chk_offset, stats,
                              chk)
        ctx.geom, ctx.chunk, ctx.return_alpha = geom, chunk, return_alpha
        rows = stats[:3]
        if return_alpha:
            rows = torch.cat([rows, 1.0 - stats[3:4]], dim=0)
        rows = rows.reshape(rows.shape[0], tiles_x * tiles_y, tile_w * tile_h)
        return _assemble(rows, width=width, height=height, **geom)

    @staticmethod
    def backward(ctx, d_fb):
        with trace.span("compositor.bwd"):
            sorted_feats, tile_start, tile_count, chk_offset, stats, chk = ctx.saved_tensors
            g = ctx.geom
            tiles_x, tiles_y, tile_w, tile_h = (
                g["tiles_x"], g["tiles_y"], g["tile_w"], g["tile_h"]
            )
            fh, fw = tiles_y * tile_h, tiles_x * tile_w
            _, h, w = d_fb.shape
            # Cotangent rows per pixel on the padded tile grid (zero past the
            # image): 0–2 dL/drgb, 3 dL/dT_final = −dL/dalpha, 4–7 zero.
            rows = d_fb.new_zeros((STATS_ROWS, fh, fw))
            rows[:3, :h, :w] = d_fb[:3]
            if ctx.return_alpha:
                rows[3, :h, :w] = -d_fb[3]
            gout = (
                rows.reshape(STATS_ROWS, tiles_y, tile_h, tiles_x, tile_w)
                .permute(0, 1, 3, 2, 4)
                .reshape(STATS_ROWS, tiles_x * tiles_y * tile_w * tile_h)
                .contiguous()
            )
            d_feats = train_backward(sorted_feats, tile_start, tile_count, chk_offset,
                                     gout, stats, chk, chunk=ctx.chunk, **g)
            return (d_feats,) + (None,) * 10


def composite_tiles_train(
    sorted_feats: torch.Tensor,  # (C + K, 16) f32 (ops/compositing.py layout)
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    width: int,
    height: int,
    chunk_size: int = 128,
    return_alpha: bool = False,
) -> torch.Tensor:
    """Drop-in differentiable replacement for ``composite_tiles_diff``
    (same inputs and outputs, no ``max_chunks`` truncation): the (3[+1],
    H, W) framebuffer, differentiable in ``sorted_feats`` through the
    backward kernel. Needs :func:`train_kernel_compatible` tiles; callers
    take ``composite_tiles_diff`` otherwise."""
    if not train_kernel_compatible(tile_w, tile_h):
        raise ValueError(
            f"composite_tiles_train: {tile_w}x{tile_h} tiles are not a multiple "
            "of 128 pixels"
        )
    if sorted_feats.dim() != 2 or sorted_feats.shape[1] != FEAT_DIM:
        raise ValueError("composite_tiles_train: sorted_feats must be (C, 16)")
    return _CompositeTrain.apply(
        sorted_feats.to(torch.float32).contiguous(), tile_start.to(torch.int32).contiguous(),
        tile_count.to(torch.int32).contiguous(), tiles_x, tiles_y, tile_w, tile_h,
        width, height, chunk_size, return_alpha,
    )
