"""Per-tile front-to-back compositing of packed instance records.

Counterpart of ``gaussianrenderer_tpu/ops/pallas/tile_render2.py``.
``composite_tiles_packed`` launches the hand-written CUDA kernel
(``csrc/tile_render2.cu``) for tensors on a CUDA device and runs
:func:`composite_tiles_packed_plain`, the same function in plain PyTorch,
for tensors on the CPU.

What both compute, per tile: walk the tile's sorted lane range
``[start, start + count)`` in ``chunk``-lane windows aligned to multiples
of ``chunk``; decode the five u32 rows of each lane (center, Cholesky
conic, opacity, 10-bit rgb, u8 AABB); per pixel take
``alpha = min(fast_exp(−½(md² + q0)), 0.99)``, zeroed outside the AABB,
below 1e-3 or outside the range; weight ``alpha·T`` while ``T ≥ 1e-3``;
update ``T ·= 1 − alpha`` ungated; and leave the tile at a chunk end once
no pixel has ``T ≥ 1e-3``. The quadratic is the TPU kernel's direct form
(``mxu_q=False``), which its own tests hold within 1e-3 of the MXU form.

Both take every tile that ``RenderConfig.packed_compatible`` takes (sides
≤ 255 pixels, a pixel count that is a multiple of 128) and, with the
census, up to ``MAX_SAT_BLOCKS`` 16×16 blocks a tile, as the TPU kernel
does (:func:`check_args`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from gaussianrenderer_tpu_torch import _build
from gaussianrenderer_tpu_torch.ops.instances import (
    CENTER_OFFSET,
    CENTER_SCALE,
    COLOR_SCALE,
    RGB_SCALE,
    _dec_e6m10,
    _dec_s1e6m9,
)

ALPHA_EPS = 1e-3
T_EPS = 1e-3
ALPHA_MAX = 0.99
PACK_ROWS = 5
#: Edge of the saturation census blocks (``with_sat``), in pixels.
SAT_BLOCK = 16
#: Census blocks a tile may have (the TPU kernel's ``SAT_PAD``).
MAX_SAT_BLOCKS = 128
#: Longest tile side: tile-local AABBs are u8.
MAX_TILE_SIDE = 255
#: Tiles of 1024 pixels the plain version vectorizes over at a time
#: (fewer for larger tiles).
TILE_BATCH = 16


def fast_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) for x ≤ 0 via exponent bit-stuffing and a degree-4 minimax
    polynomial (max relative error 2.6e-6); inputs ≤ −87 flush to 0.
    Bit for bit the TPU kernel's ``_fast_exp`` and the CUDA kernel's."""
    y = torch.clamp_min(x, -88.0) * 1.4426950408889634
    yi = torch.floor(y)
    t = y - yi
    p = 1.0000026036 + t * (
        0.6930037261 + t * (0.2414429825 + t * (0.0520114241 + t * 0.013534055))
    )
    exp_bits = (yi.to(torch.int32) + 127) << 23
    scale = torch.clamp(exp_bits, 0, 254 << 23).view(torch.float32)
    return p * scale


def _decode(packed_feats: torch.Tensor, depth_row: Optional[torch.Tensor]):
    """(5, C) int32 records → per-lane decoded fields, each (C,)."""
    r = packed_feats.to(torch.int64) & 0xFFFFFFFF
    coarse = ((r[3] >> 30) & 1) != 0
    c_scale = torch.where(coarse, 1.0, 1.0 / CENTER_SCALE)
    c_bias = torch.where(coarse, 32768.0, CENTER_OFFSET)
    cx = (r[0] >> 16).to(torch.float32) * c_scale - c_bias
    cy = (r[0] & 0xFFFF).to(torch.float32) * c_scale - c_bias
    u = _dec_e6m10(r[1] >> 16)
    w = _dec_e6m10(r[1] & 0xFFFF)
    v = _dec_s1e6m9(r[2] >> 16)
    op = torch.clamp_min((r[2] & 0xFFFF).to(torch.float32) * (1.0 / COLOR_SCALE), 1e-6)
    colors = [
        ((r[3] >> s) & 0x3FF).to(torch.float32) * (1.0 / RGB_SCALE)
        for s in (0, 10, 20)
    ]
    if depth_row is not None:
        colors.append(depth_row.to(torch.float32))
    return dict(
        cx=cx, cy=cy, a=u * u, b=2.0 * u * v, c=v * v + w * w,
        q0=-2.0 * torch.log(op),
        xmin=r[4] & 0xFF, ymin=(r[4] >> 8) & 0xFF,
        xmax=(r[4] >> 16) & 0xFF, ymax=(r[4] >> 24) & 0xFF,
        colors=torch.stack(colors, 0),  # (3|4, C)
    )


def composite_tiles_packed_plain(
    packed_feats: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    width: int,
    height: int,
    chunk: int = 128,
    out_alpha: bool = False,
    depth_row: Optional[torch.Tensor] = None,
    tiles: Optional[Sequence[int]] = None,
    chunks_walked: Optional[torch.Tensor] = None,
    with_sat: bool = False,
    pair_counts: Optional[torch.Tensor] = None,
):
    """The compositor in plain PyTorch, on the tensors' own device.

    Returns the (nc, height, width) framebuffer, or with ``tiles`` only
    those tiles as (nc, len(tiles), tile_h, tile_w) blocks (pixels outside
    the image included). Tiles run ``TILE_BATCH`` at a time, each batch
    vectorized over (tile, pixel, lane) with a loop over chunk index.
    ``chunks_walked`` (T,) int32, when given, receives each computed
    tile's number of chunks walked. ``with_sat`` also returns the
    per-16×16-block saturation lanes, (len(tiles)·B,) int32 in tile
    order (see :func:`composite_tiles_packed`).

    ``pair_counts``, when given, is a (4,) int64 tensor to which the
    (in-image pixel, walked lane in range) pairs of the computed tiles are
    added: inside the lane's u8 AABB before the pixel's stop (T before the
    lane ≥ 1e-3), outside it before the stop, inside after the stop,
    outside after the stop. They are the work the function needs
    (``chip_smoke.compositor_bound_ms``).
    """
    dev = packed_feats.device
    k = chunk
    p = tile_h * tile_w
    nc = 3 + int(out_alpha) + int(depth_row is not None)
    all_tiles = tiles is None
    tile_ids = (
        torch.arange(tiles_x * tiles_y, device=dev)
        if all_tiles
        else torch.as_tensor(list(tiles), dtype=torch.int64, device=dev)
    )
    n_lanes = packed_feats.shape[1]
    dec = _decode(packed_feats, depth_row)
    pix = torch.arange(p, device=dev)
    px_i = (pix % tile_w)[None, :, None]  # (1, P, 1)
    py_i = (pix // tile_w)[None, :, None]
    px = px_i.to(torch.float32)
    py = py_i.to(torch.float32)
    lane_iota = torch.arange(k, device=dev)
    if with_sat:
        if tile_w % SAT_BLOCK or tile_h % SAT_BLOCK:
            raise ValueError(f"with_sat needs {SAT_BLOCK}px-divisible tiles")
        bw, bh = tile_w // SAT_BLOCK, tile_h // SAT_BLOCK
        sat_all = torch.full((tile_ids.numel(), bw * bh), -1, dtype=torch.int64,
                             device=dev)

    blocks = torch.zeros((nc, tile_ids.numel(), p), dtype=torch.float32, device=dev)
    batch = max(1, min(TILE_BATCH, TILE_BATCH * 1024 // p))
    for b0 in range(0, tile_ids.numel(), batch):
        tb = tile_ids[b0:b0 + batch]
        nb = tb.numel()
        start = tile_start[tb].to(torch.int64)
        count = tile_count[tb].to(torch.int64)
        aligned = (start // k) * k
        num_chunks = (start + count - aligned + k - 1) // k
        trans = torch.ones((nb, p), dtype=torch.float32, device=dev)
        acc = torch.zeros((nb, p, nc - int(out_alpha)), dtype=torch.float32, device=dev)
        active = num_chunks > 0
        walked = torch.zeros(nb, dtype=torch.int64, device=dev)
        in_img = (
            ((tb % tiles_x) * tile_w)[:, None] + (pix % tile_w)[None, :] < width
        ) & (((tb // tiles_x) * tile_h)[:, None] + (pix // tile_w)[None, :] < height)
        if with_sat:
            sat = sat_all[b0:b0 + nb]
        ci = 0
        while bool(active.any()):
            slot = aligned[:, None] + ci * k + lane_iota[None, :]  # (nb, K)
            k_valid = (
                (slot >= start[:, None]) & (slot < (start + count)[:, None])
                & active[:, None]
            )
            # A tile with count > 0 implies n_lanes > 0; masked lanes of an
            # empty tile only need an in-range index.
            s = torch.clamp(slot, 0, max(n_lanes - 1, 0))
            g = {key: dec[key][s][:, None, :] for key in
                 ("cx", "cy", "a", "b", "c", "q0", "xmin", "ymin", "xmax", "ymax")}
            cols = dec["colors"][:, s].permute(1, 2, 0)  # (nb, K, ch)
            dx = px - g["cx"]  # (nb, P, K)
            dy = py - g["cy"]
            md2 = (g["a"] * dx + g["b"] * dy) * dx + g["c"] * dy * dy
            q = md2 + g["q0"]
            alpha = torch.clamp_max(fast_exp(-0.5 * q), ALPHA_MAX)
            # Unsigned AABB compare: 0 ≤ px − xmin ≤ xmax − xmin.
            ux = (px_i - g["xmin"]) & 0xFFFFFFFF
            uy = (py_i - g["ymin"]) & 0xFFFFFFFF
            inside = (ux <= ((g["xmax"] - g["xmin"]) & 0xFFFFFFFF)) & (
                uy <= ((g["ymax"] - g["ymin"]) & 0xFFFFFFFF)
            )
            alpha = torch.where(
                inside & (alpha >= ALPHA_EPS) & k_valid[:, None, :], alpha, 0.0
            )
            # Sequential transmittance: cumprod of [T, 1−α₀, 1−α₁, …] gives
            # T before each lane in the kernel's multiplication order.
            seq = torch.cat([trans[:, :, None], 1.0 - alpha], dim=2)
            t_all = torch.cumprod(seq, dim=2)
            t_before = t_all[:, :, :k]
            weights = torch.where(t_before >= T_EPS, t_before * alpha, 0.0)
            if pair_counts is not None:
                pair = in_img[:, :, None] & k_valid[:, None, :]
                live = t_before >= T_EPS
                pair_counts += torch.stack([
                    (pair & live & inside).sum(), (pair & live & ~inside).sum(),
                    (pair & ~live & inside).sum(), (pair & ~live & ~inside).sum(),
                ]).to(pair_counts.device)
            acc = acc + torch.stack(
                [(weights * cols[:, None, :, j]).sum(2) for j in range(cols.shape[2])],
                dim=2,
            )
            trans = torch.where(active[:, None], t_all[:, :, k], trans)
            if with_sat:
                # A walked block whose in-image pixels all have T < 1e-3
                # (a block with none counts as saturated) records the
                # chunk's last real lane, once.
                open_px = in_img & (trans >= T_EPS)
                blk_open = open_px.reshape(nb, bh, SAT_BLOCK, bw, SAT_BLOCK)
                blk_open = blk_open.any(4).any(2).reshape(nb, bh * bw)
                lane_end = torch.minimum(aligned + (ci + 1) * k, start + count) - 1
                rec = active[:, None] & ~blk_open & (sat < 0)
                sat.copy_(torch.where(rec, lane_end[:, None], sat))
            walked = walked + active.to(torch.int64)
            ci += 1
            active = active & (ci < num_chunks) & (trans.amax(1) >= T_EPS)
        if chunks_walked is not None:
            chunks_walked[tb] = walked.to(chunks_walked.dtype)
        rows = [acc[:, :, 0], acc[:, :, 1], acc[:, :, 2]]
        if out_alpha:
            rows.append(1.0 - trans)
        if depth_row is not None:
            rows.append(acc[:, :, 3])
        blocks[:, b0:b0 + nb] = torch.stack(rows, 0)

    blocks = blocks.reshape(nc, tile_ids.numel(), tile_h, tile_w)
    if all_tiles:
        fb = blocks.reshape(nc, tiles_y, tiles_x, tile_h, tile_w)
        fb = fb.permute(0, 1, 3, 2, 4).reshape(nc, tiles_y * tile_h, tiles_x * tile_w)
        blocks = fb[:, :height, :width].contiguous()
    if with_sat:
        return blocks, sat_all.reshape(-1).to(torch.int32)
    return blocks


def tile_blocks(
    fb: torch.Tensor, tiles: Sequence[int], *, tiles_x: int, tile_w: int, tile_h: int
) -> torch.Tensor:
    """(nc, H, W) framebuffer → (nc, len(tiles), tile_h, tile_w) blocks,
    zero where a tile reaches past the image."""
    nc, h, w = fb.shape
    tiles_y = -(-h // tile_h)
    pad = torch.zeros(
        (nc, tiles_y * tile_h, tiles_x * tile_w), dtype=fb.dtype, device=fb.device
    )
    pad[:, :h, :w] = fb
    grid = pad.reshape(nc, tiles_y, tile_h, tiles_x, tile_w).permute(0, 1, 3, 2, 4)
    grid = grid.reshape(nc, tiles_y * tiles_x, tile_h, tile_w)
    return grid[:, torch.as_tensor(list(tiles), device=fb.device)]


def check_args(
    packed_feats: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    width: int,
    height: int,
    chunk: int = 128,
    out_alpha: bool = False,
    depth_row: Optional[torch.Tensor] = None,
    chunks_walked: Optional[torch.Tensor] = None,
    with_sat: bool = False,
) -> None:
    """Raise ``ValueError`` for arguments the kernel does not take. It
    takes every tile ``RenderConfig.packed_compatible`` takes (a pixel
    count that is a multiple of 128, sides ≤ 255) and census tiles of at
    most ``MAX_SAT_BLOCKS`` blocks. Reads only shapes, types and devices,
    so it runs without a card."""
    num_tiles = tiles_x * tiles_y
    p = tile_w * tile_h
    c = packed_feats.shape[1] if packed_feats.dim() == 2 else -1
    n_blocks = (tile_w // SAT_BLOCK) * (tile_h // SAT_BLOCK)
    checks = [
        (packed_feats.dtype == torch.int32 and packed_feats.shape[0] == PACK_ROWS
         and c >= 0, "packed_feats must be (5, C) int32"),
        (tile_start.dtype == torch.int32 and tuple(tile_start.shape) == (num_tiles,),
         f"tile_start must be ({num_tiles},) int32"),
        (tile_count.dtype == torch.int32 and tuple(tile_count.shape) == (num_tiles,),
         f"tile_count must be ({num_tiles},) int32"),
        (depth_row is None or (depth_row.dtype == torch.float32
                               and tuple(depth_row.shape) == (c,)),
         "depth_row must be (C,) float32"),
        (chunks_walked is None or (chunks_walked.dtype == torch.int32
                                   and tuple(chunks_walked.shape) == (num_tiles,)),
         f"chunks_walked must be ({num_tiles},) int32"),
        (p > 0 and p % 128 == 0, "tile_w*tile_h must be a positive multiple of 128"),
        (tile_w <= MAX_TILE_SIDE and tile_h <= MAX_TILE_SIDE,
         f"tile sides must be ≤ {MAX_TILE_SIDE} (u8 tile-local AABBs)"),
        (1 <= chunk <= 1024, "chunk must be in [1, 1024]"),
        (tiles_x * tile_w >= width and tiles_y * tile_h >= height,
         "the tile grid must cover the image"),
        (not with_sat or (tile_w % SAT_BLOCK == 0 and tile_h % SAT_BLOCK == 0),
         f"with_sat needs {SAT_BLOCK}px-divisible tiles"),
        (not with_sat or n_blocks <= MAX_SAT_BLOCKS,
         f"with_sat takes at most {MAX_SAT_BLOCKS} census blocks a tile"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"composite_tiles_packed: {msg}")
    dev = packed_feats.device
    tensors = [packed_feats, tile_start, tile_count]
    tensors += [t for t in (depth_row, chunks_walked) if t is not None]
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(
                "composite_tiles_packed: inputs must be contiguous and on one device"
            )


def composite_tiles_packed(
    packed_feats: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    width: int,
    height: int,
    chunk: int = 128,
    out_alpha: bool = False,
    depth_row: Optional[torch.Tensor] = None,
    chunks_walked: Optional[torch.Tensor] = None,
    with_sat: bool = False,
):
    """Composite all tiles from packed records; returns (3, H, W) f32 plus
    the optional rows [alpha, depth] in that order.

    ``packed_feats`` is (5, C) int32 holding the u32 rows, ``tile_start``
    and ``tile_count`` are (T,) int32 ranges into it, and ``depth_row`` is
    an optional (C,) f32 per-lane camera-space depth, which adds the
    expected-depth row Σ w·d. ``chunks_walked`` is an optional (T,) int32
    output of chunks each tile walked before its early exit.

    ``with_sat=True`` returns ``(fb, sat_idx)``: ``sat_idx`` is (T·B,)
    int32, B = (tile_w/16)·(tile_h/16) blocks per tile in (by, bx)
    row-major order. After each walked chunk, a block that has not yet
    recorded and has no in-image pixel with T ≥ 1e-3 records the chunk's
    last real lane, min(aligned + (i+1)·chunk, start + count) − 1; −1
    means never. As in the TPU kernel, a block with no in-image pixel
    records at its tile's first walked chunk, and a tile with no lanes
    walks one chunk when its start is not chunk-aligned (its off-image
    blocks then record start − 1), none otherwise.

    CUDA tensors launch the kernel (counted in ``launches``); CPU tensors
    run :func:`composite_tiles_packed_plain`.
    """
    kw = dict(
        tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
        width=width, height=height, chunk=chunk, out_alpha=out_alpha,
        depth_row=depth_row, chunks_walked=chunks_walked, with_sat=with_sat,
    )
    dev = packed_feats.device
    if dev.type == "cpu":
        return composite_tiles_packed_plain(packed_feats, tile_start, tile_count, **kw)
    if dev.type != "cuda":
        raise ValueError(f"composite_tiles_packed: unsupported device {dev}")

    check_args(packed_feats, tile_start, tile_count, **kw)
    num_tiles = tiles_x * tiles_y
    c = packed_feats.shape[1]
    lib = _build.load("tile_render2")
    nc = 3 + int(out_alpha) + int(depth_row is not None)
    out = torch.empty((nc, height, width), dtype=torch.float32, device=dev)
    sat_idx = None
    if with_sat:
        n_blocks = (tile_w // SAT_BLOCK) * (tile_h // SAT_BLOCK)
        sat_idx = torch.empty((num_tiles * n_blocks,), dtype=torch.int32, device=dev)
    n_state = lib.gr_tile_render2_state_floats(num_tiles, tile_w, tile_h, int(out_alpha),
                                               int(with_sat))
    state = None
    if n_state:
        state = torch.empty((n_state,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gr_tile_render2(
            packed_feats.data_ptr(), c, tile_start.data_ptr(), tile_count.data_ptr(),
            None if depth_row is None else depth_row.data_ptr(), out.data_ptr(),
            None if chunks_walked is None else chunks_walked.data_ptr(),
            None if sat_idx is None else sat_idx.data_ptr(),
            None if state is None else state.data_ptr(),
            tiles_x, tiles_y, tile_w, tile_h, width, height, chunk,
            int(out_alpha), int(depth_row is not None), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "tile_render2 kernel launch failed: "
            f"{lib.gr_cuda_error_string(rc).decode()} (cudaError {rc})"
        )
    composite_tiles_packed.launches += 1
    return (out, sat_idx) if with_sat else out


#: Kernel launches made through ``composite_tiles_packed`` in this process.
composite_tiles_packed.launches = 0
