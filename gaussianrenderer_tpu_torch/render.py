"""One rendered frame on the packed path (PyTorch port of ``render.py``).

    framebuffer, stats = render_frame(scene, camera_params, cfg)

Pipeline, each stage on the scene's device:

1. ``slice_spacetime`` + ``preprocess_gaussians`` — cull, SH color, EWA
   projection, pixel AABB and tile rect (ops/projection.py);
2. ``build_packed_instances`` — one 5-row u32 record per live
   (splat, tile) pair, sorted by (tile, quantized depth), with per-tile
   ranges (ops/instances.py);
3. ``composite_tiles_packed`` — the CUDA tile compositor, or its plain
   PyTorch version for CPU tensors (ops/cuda/tile_render2.py);
4. ``_finish_fb`` — background composite and channel selection.

The framebuffer is planar (3, H, W) float32 with row 0 at NDC y = −1.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gaussianrenderer_tpu_torch.config import RenderConfig
from gaussianrenderer_tpu_torch.ops.cuda.tile_render2 import composite_tiles_packed
from gaussianrenderer_tpu_torch.ops.instances import build_packed_instances
from gaussianrenderer_tpu_torch.ops.projection import (
    preprocess_gaussians,
    slice_spacetime,
)
from gaussianrenderer_tpu_torch.scene.camera import CameraParams
from gaussianrenderer_tpu_torch.scene.gaussians import GaussianScene


class RenderStats(NamedTuple):
    """Per-frame diagnostics (0-d device tensors; read them lazily)."""

    num_culled: torch.Tensor  # () int64 — Gaussians surviving the cull
    num_instances: torch.Tensor  # () int64 — (gaussian, tile) pairs emitted
    #: () bool — instances were dropped. The count → scan emitter has no
    #: static capacity, so this is always False.
    overflow: torch.Tensor
    #: (len(AREA_BUCKETS)+1,) int64 effective-lane histogram of the valid
    #: splats (ops/instances.py), or None where a path does not report it.
    area_hist: Optional[torch.Tensor] = None
    #: () bool — a tile-local center saturated the fixed-point encode.
    center_clipped: Optional[torch.Tensor] = None


def _check_supported(cfg: RenderConfig) -> None:
    if cfg.compositor != "packed" or not cfg.packed_compatible:
        raise NotImplementedError(
            "render_frame: only compositor='packed' on a packed-compatible "
            f"tile grid is ported so far (got compositor={cfg.compositor!r}, "
            f"tiles {cfg.tile_w}x{cfg.tile_h})"
        )
    if cfg.sat_cull:
        raise NotImplementedError("render_frame: sat_cull is not ported yet")


def render_frame(
    scene: GaussianScene,
    cam: CameraParams,
    cfg: RenderConfig,
    time_value: Optional[float] = None,
) -> Tuple[torch.Tensor, RenderStats]:
    """Render one frame on the scene's device; returns ``(fb, stats)``
    with ``fb`` (3[+alpha][+depth], H, W) float32.

    ``time_value`` slices a 4D spacetime scene at that time (ignored for
    static scenes). ``cfg.tiers`` and ``cfg.tier_boost`` size the JAX
    package's static instance lanes; emission here has no static size, so
    they do not apply.
    """
    _check_supported(cfg)
    scene, extra_opacity = slice_spacetime(scene, time_value)
    proj = preprocess_gaussians(
        scene,
        cam,
        width=cfg.width,
        height=cfg.height,
        tile_w=cfg.tile_w,
        tile_h=cfg.tile_h,
        tiles_x=cfg.tiles_x,
        tiles_y=cfg.tiles_y,
        sh_degree=cfg.sh_degree,
        extra_opacity_scale=extra_opacity,
        quantize_centers=cfg.quantize_centers,
        ewa_dilation=cfg.ewa_dilation,
        ewa_compensate=cfg.ewa_compensate,
    )
    want_alpha = cfg.output_alpha or cfg.background is not None
    inst = build_packed_instances(
        proj,
        tiles_x=cfg.tiles_x,
        tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w,
        tile_h=cfg.tile_h,
        near=cam.near,
        far=cam.far,
        want_depth=cfg.output_depth,
    )
    fb = composite_tiles_packed(
        inst.packed_feats,
        inst.tile_start,
        inst.tile_count,
        tiles_x=cfg.tiles_x,
        tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w,
        tile_h=cfg.tile_h,
        width=cfg.width,
        height=cfg.height,
        chunk=cfg.packed_chunk,
        out_alpha=want_alpha,
        depth_row=inst.depth_f32,
    )
    stats = RenderStats(
        num_culled=proj.valid.sum(),
        num_instances=inst.total_instances,
        overflow=inst.overflow,
        area_hist=inst.area_hist,
        center_clipped=inst.center_clipped,
    )
    return _finish_fb(fb, cfg), stats


def _finish_fb(fb: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Background composite + output-channel selection.

    ``fb`` rows arrive as [rgb(3)] [alpha (when requested)] [depth (when
    cfg.output_depth)]. ``cfg.background`` composites rgb + T_final·bg
    (T_final = 1 − alpha); the alpha row is kept only when
    ``cfg.output_alpha``; the depth row always passes through."""
    if cfg.background is None:
        return fb
    bg = torch.tensor(cfg.background, dtype=torch.float32, device=fb.device)
    rows = [fb[:3] + (1.0 - fb[3:4]) * bg[:, None, None]]
    if cfg.output_alpha:
        rows.append(fb[3:4])
    if cfg.output_depth:
        rows.append(fb[4:5])
    return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]


def framebuffer_to_image(fb, flip_y: bool = True) -> np.ndarray:
    """Planar (3, H, W) float framebuffer (tensor or array) → (H, W, 3)
    uint8. ``flip_y`` puts the top image row (NDC y = +1) first. Tensors
    convert on their own device, so only 3 bytes per pixel are copied."""
    if isinstance(fb, torch.Tensor):
        img = (torch.clamp(fb[:3].permute(1, 2, 0), 0.0, 1.0) * 255.0 + 0.5)
        img = img.to(torch.uint8).cpu().numpy()
    else:
        img = np.asarray(fb)[:3].transpose(1, 2, 0)
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(img[::-1] if flip_y else img)


def _png_encode(img: np.ndarray) -> bytes:
    """Minimal 8-bit RGB PNG writer (stdlib zlib only)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def save_png(fb, path: str, flip_y: bool = True) -> None:
    """Write a (3, H, W) float framebuffer or an (H, W, 3) uint8 image to
    a PNG file."""
    if isinstance(fb, torch.Tensor) or np.asarray(fb).dtype != np.uint8:
        arr = framebuffer_to_image(fb, flip_y=flip_y)
    else:
        arr = np.asarray(fb)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (3,H,W) float or (H,W,3) uint8, got {arr.shape}")
    with open(path, "wb") as fh:
        fh.write(_png_encode(np.ascontiguousarray(arr)))
