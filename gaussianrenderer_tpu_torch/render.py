"""Rendered frames (PyTorch port of ``render.py``).

    framebuffer, stats = render_frame(scene, camera_params, cfg)
    render = make_renderer(scene, cfg)           # a session
    framebuffer, stats = render(camera_params)   # once per frame

Packed path (``compositor="packed"`` on a packed-compatible grid), each
stage on the scene's device:

1. ``slice_spacetime`` + ``preprocess_gaussians`` — cull, SH color, EWA
   projection, pixel AABB and tile rect (ops/projection.py);
2. ``build_packed_instances`` — one 5-row u32 record per live
   (splat, tile) pair, sorted by (tile, quantized depth), with per-tile
   ranges (ops/instances.py);
3. ``composite_tiles_packed`` — the CUDA tile compositor, or its plain
   PyTorch version for CPU tensors (ops/cuda/tile_render2.py);
4. ``_finish_fb`` — background composite and channel selection.

With ``cfg.sat_cull`` and a ``sat_state`` (the previous frame's cutoff
image), the saturation cull (ops/satcull.py) drops splats and
(splat, tile) pairs behind last frame's saturated blocks before
emission, and the compositor's census gives this frame's cutoffs.

The f32 tile-sort path serves ``compositor="xla"``, ``"diff"`` (the
differentiable one training uses) and ``"packed"`` on a grid the packed
records cannot describe: ``build_sorted_instances`` (ops/tiling.py),
``build_features`` and the feature gather (ops/compositing.py), then
``composite_tiles_xla``, ``composite_tiles_diff`` or, for ``"diff"`` with
``cfg.diff_kernel`` on 128-pixel-multiple tiles and no depth row, the
training compositor's kernels (``composite_tiles_train``,
ops/tile_train.py).

The framebuffer is planar (3, H, W) float32 with row 0 at NDC y = −1.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussianrenderer_tpu_torch.config import RenderConfig
from gaussianrenderer_tpu_torch.ops import satcull
from gaussianrenderer_tpu_torch.ops.compositing import (
    build_features,
    composite_tiles_diff,
    composite_tiles_xla,
    gather_sorted_features,
    gather_sorted_features_seg,
)
from gaussianrenderer_tpu_torch.ops.cuda.tile_render2 import composite_tiles_packed
from gaussianrenderer_tpu_torch.ops.instances import _emission_probe, build_packed_instances
from gaussianrenderer_tpu_torch.ops.projection import (
    preprocess_gaussians,
    slice_spacetime,
)
from gaussianrenderer_tpu_torch.ops.tile_train import (
    composite_tiles_train,
    train_kernel_compatible,
)
from gaussianrenderer_tpu_torch.ops.tiling import build_sorted_instances
from gaussianrenderer_tpu_torch.scene.camera import CameraParams
from gaussianrenderer_tpu_torch.scene.gaussians import GaussianScene
from gaussianrenderer_tpu_torch.utils import trace


class RenderStats(NamedTuple):
    """Per-frame diagnostics (0-d device tensors; read them lazily)."""

    num_culled: torch.Tensor  # () int64 — Gaussians surviving the cull
    num_instances: torch.Tensor  # () int64 — (gaussian, tile) pairs emitted
    #: () bool — instances were dropped. The count → scan emitter has no
    #: static capacity, so this is always False.
    overflow: torch.Tensor
    #: (len(AREA_BUCKETS)+1,) int64 effective-lane histogram of the valid
    #: splats (ops/instances.py; packed path only, None otherwise).
    area_hist: Optional[torch.Tensor] = None
    #: () bool — a tile-local center saturated the fixed-point encode
    #: (packed path only).
    center_clipped: Optional[torch.Tensor] = None
    #: () int64 (sat_cull frames only) — splats dropped by the saturation
    #: cull this frame.
    sat_culled: Optional[torch.Tensor] = None
    #: () int64 (sat_cull frames only) — blocks that were saturated last
    #: frame (culling active) but did not saturate this frame: the
    #: disocclusion signal. They publish SAT_NONE for the next frame.
    sat_risk: Optional[torch.Tensor] = None


def render_frame(
    scene: GaussianScene,
    cam: CameraParams,
    cfg: RenderConfig,
    time_value: Optional[float] = None,
    sat_state: Optional[torch.Tensor] = None,
):
    """Render one frame on the scene's device; returns ``(fb, stats)``
    with ``fb`` (3[+alpha][+depth], H, W) float32.

    ``time_value`` slices a 4D spacetime scene at that time (ignored for
    static scenes). ``cfg.tiers`` and ``cfg.tier_boost`` size the JAX
    package's static instance lanes; emission here has no static size, so
    they do not apply.

    With ``cfg.sat_cull`` and ``sat_state`` (the previous frame's (sy, sx)
    cutoff image; ``satcull.initial_cutoff`` for the first frame) a packed
    frame is culled and the return is ``(fb, stats, new_sat_state)``;
    without ``sat_state``, or on the tile-sort path, the frame renders
    unculled and returns two values. ``make_renderer`` threads the state.
    """
    return _render_impl(scene, cam, cfg, time_value, sat_state=sat_state)


def _render_impl(
    scene: GaussianScene,
    cam: CameraParams,
    cfg: RenderConfig,
    time_value: Optional[float] = None,
    sat_state: Optional[torch.Tensor] = None,
):
    """The body of ``render_frame``. ``train.render_for_training`` takes
    its two halves, :func:`_project` and :func:`_render_tile_sort`, apart."""
    if cfg.compositor not in ("packed", "xla", "diff"):
        raise ValueError(
            f"unknown compositor {cfg.compositor!r}; expected 'packed', 'xla', "
            "or 'diff'"
        )
    proj = _project(scene, cam, cfg, time_value)
    if cfg.compositor != "packed" or not cfg.packed_compatible:
        return _render_tile_sort(proj, cam, cfg)

    want_alpha = cfg.output_alpha or cfg.background is not None
    with_sat = cfg.sat_cull and sat_state is not None
    sat_culled = sat_cut_q = None
    if with_sat:
        proj, sat_culled, sat_cut_q = _sat_cull(proj, cam, cfg, sat_state)
    inst = build_packed_instances(
        proj,
        tiles_x=cfg.tiles_x,
        tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w,
        tile_h=cfg.tile_h,
        near=cam.near,
        far=cam.far,
        # The census decodes lane depth; the framebuffer gets a depth row
        # only when asked for.
        want_depth=cfg.output_depth or with_sat,
        sat_cut_q=sat_cut_q,
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
        depth_row=inst.depth_f32 if cfg.output_depth else None,
        with_sat=with_sat,
    )
    sat_risk = new_cutoff = None
    if with_sat:
        fb, sat_idx = fb
        new_cutoff = satcull.cutoff_from_sat(
            sat_idx,
            inst.depth_f32,
            tiles_x=cfg.tiles_x,
            tiles_y=cfg.tiles_y,
            tile_w=cfg.tile_w,
            tile_h=cfg.tile_h,
        )
        # Blocks that were culling but failed to re-saturate publish
        # SAT_NONE in new_cutoff, so the next frame heals them.
        sat_risk = (
            (sat_state < satcull.SAT_NONE) & (new_cutoff >= satcull.SAT_NONE)
        ).sum()
    stats = RenderStats(
        num_culled=proj.valid.sum(),
        num_instances=inst.total_instances,
        overflow=inst.overflow,
        area_hist=inst.area_hist,
        center_clipped=inst.center_clipped,
        sat_culled=sat_culled,
        sat_risk=sat_risk,
    )
    if with_sat:
        return _finish_fb(fb, cfg), stats, new_cutoff
    return _finish_fb(fb, cfg), stats


def _project(scene: GaussianScene, cam: CameraParams, cfg: RenderConfig, time_value=None,
             ndc_probe: Optional[torch.Tensor] = None):
    """``slice_spacetime`` + ``preprocess_gaussians`` under ``cfg``, with the
    training hook ``ndc_probe`` ((2, N) zeros added to the NDC centers,
    whose gradient is the view-space positional gradient)."""
    scene, extra_opacity = slice_spacetime(scene, time_value)
    return preprocess_gaussians(
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
        ndc_probe=ndc_probe,
    )


def _render_tile_sort(proj, cam: CameraParams, cfg: RenderConfig):
    """The f32 tile-sort path: sorted instances, gathered feature rows and
    the xla, diff or training compositor; returns ``(fb, stats)``."""
    want_alpha = cfg.output_alpha or cfg.background is not None
    want_depth = cfg.output_depth
    with trace.span("tiling"):
        assignment = build_sorted_instances(
            proj, tiles_x=cfg.tiles_x, num_tiles=cfg.num_tiles, near=cam.near,
            far=cam.far,
        )
    geom = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
                tile_h=cfg.tile_h, width=cfg.width, height=cfg.height,
                chunk_size=cfg.chunk_size, return_alpha=want_alpha)
    ranges = (assignment.tile_start, assignment.tile_count)
    diff = cfg.compositor == "diff"
    with trace.span("gather"):
        feats = build_features(proj)
        # "packed" takes the plain gather only on a grid that is not
        # packed-compatible.
        gather = gather_sorted_features_seg if diff else gather_sorted_features
        sorted_feats = gather(feats, assignment, cfg.chunk_size)
    with trace.span("compositor"):
        if not diff:
            fb = composite_tiles_xla(sorted_feats, *ranges, **geom,
                                     return_depth=want_depth)
        elif (
            cfg.diff_kernel
            and train_kernel_compatible(cfg.tile_w, cfg.tile_h)
            and not want_depth
        ):
            fb = composite_tiles_train(sorted_feats, *ranges, **geom)
        else:
            fb = composite_tiles_diff(sorted_feats, *ranges, **geom,
                                      max_chunks=cfg.diff_max_chunks,
                                      return_depth=want_depth)
    stats = RenderStats(
        num_culled=proj.valid.sum(),
        num_instances=assignment.total_instances,
        overflow=assignment.overflow,
    )
    return _finish_fb(fb, cfg), stats


def _sat_cull(proj, cam: CameraParams, cfg: RenderConfig, sat_state: torch.Tensor):
    """The saturation cull before emission: returns the projection with
    culled splats made invalid, the culled count, and the per-tile
    cutoff table of the per-position cull."""
    f32 = torch.float32
    sy, sx = satcull.sat_grid(cfg.tiles_x, cfg.tiles_y, cfg.tile_w, cfg.tile_h)
    depth_bits = min(32 - max(int(cfg.num_tiles).bit_length(), 1), 24)
    # One depth-quantization step of the frame-sort key: (far − near) /
    # (2^depth_bits − 1) in f32, which the JAX package's jitted frame
    # computes as a multiply by the f32 reciprocal (XLA's rewrite of a
    # division by a constant), so the per-tile cutoff table matches. The
    # Python float enters the f32 multiply as that f32 reciprocal.
    dev = sat_state.device
    far = torch.as_tensor(cam.far, dtype=f32, device=dev)
    near = torch.as_tensor(cam.near, dtype=f32, device=dev)
    step = (far - near) * (1.0 / ((1 << depth_bits) - 1))
    sat_eff = satcull.dilate_cutoff(sat_state, cfg.sat_dilate)
    culled = satcull.cull_mask(
        proj.valid,
        proj.depth,
        proj.aabb_px,
        satcull.build_pyramid(sat_eff),
        sx=sx,
        sy=sy,
        margin=cfg.sat_margin,
        depth_step=step,
    )
    sat_cut_q = satcull.tile_cutoff_q(
        sat_eff,
        tiles_x=cfg.tiles_x,
        tiles_y=cfg.tiles_y,
        tile_w=cfg.tile_w,
        tile_h=cfg.tile_h,
        near=cam.near,
        depth_step=step,
        margin=cfg.sat_margin,
    )
    return proj._replace(valid=proj.valid & ~culled), culled.sum(), sat_cut_q


def make_renderer(
    scene: GaussianScene,
    cfg: RenderConfig,
    auto_tier: bool = False,
    overflow_check_every: int = 16,
    scene_path: Optional[str] = None,
):
    """A render session: returns ``render(cam_params, time_value=None) ->
    (fb, stats)`` with the scene closed over.

    With ``cfg.sat_cull`` the session threads the saturation-cull state
    from ``satcull.initial_cutoff`` (frame 1 culls nothing) through each
    frame's new cutoff image. ``render.current_cfg()`` returns the
    session's config.

    The JAX session also calibrates a static instance-tier ladder
    (``auto_tier``: ``calibrate_tiers``, a calibration sidecar next to
    ``scene_path``, the ladder-driven ``auto_packed_chunk``) and renders
    from a transposed ``PreparedScene``. This port emits by count → scan
    with no static capacity, so it never overflows and has no ladder to
    calibrate: ``auto_tier``, ``overflow_check_every`` and ``scene_path``
    are accepted for the same call signature and change nothing, and the
    scene is used as it is. Stats stay device tensors; the session reads
    nothing back per frame.
    """
    del auto_tier, overflow_check_every, scene_path
    state = {"cfg": cfg, "sat": None}

    def render(cam: CameraParams, time_value=None):
        cfg_now = state["cfg"]
        if not cfg_now.sat_cull:
            return render_frame(scene, cam, cfg_now, time_value)
        if state["sat"] is None:
            state["sat"] = satcull.initial_cutoff(
                cfg_now.tiles_x, cfg_now.tiles_y, cfg_now.tile_w, cfg_now.tile_h,
                device=scene.positions.device,
            )
        fb, stats, state["sat"] = render_frame(
            scene, cam, cfg_now, time_value, sat_state=state["sat"]
        )
        return fb, stats

    render.current_cfg = lambda: state["cfg"]
    return render


def area_histogram(scene: GaussianScene, cam: CameraParams, cfg: RenderConfig) -> np.ndarray:
    """The effective-lane histogram over ``AREA_BUCKETS`` (int64) of one
    pose, from projection and prepack alone: nothing sorts and nothing
    composites. Equal to ``stats.area_hist`` of ``render_frame`` with
    ``compositor="packed"`` and the cull off (ops/instances.effective_hist
    runs the code that fills it)."""
    return _hist_probe(scene, cam, cfg)[0].cpu().numpy().astype(np.int64)


def emission_total(scene: GaussianScene, cam: CameraParams, cfg: RenderConfig) -> int:
    """The exact number of (splat, tile) instances one pose emits, from
    the same probe as :func:`area_histogram`: ``int(stats.num_instances)``
    of the packed ``render_frame`` with the cull off."""
    return int(_hist_probe(scene, cam, cfg)[1])


def _hist_probe(scene, cam, cfg):
    """Projection with ``cfg``'s arguments, then the emission probe, on
    the scene's device. The scatter reads its lane count from the card
    (as emission does); the callers read the result once."""
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
        quantize_centers=cfg.quantize_centers,
        ewa_dilation=cfg.ewa_dilation,
        ewa_compensate=cfg.ewa_compensate,
    )
    return _emission_probe(
        proj, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h,
    )


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


def framebuffer_to_uint8(fb: torch.Tensor) -> torch.Tensor:
    """The (H, W, 3) uint8 image of a planar float framebuffer tensor, on
    the tensor's device and not flipped: the part of
    ``framebuffer_to_image`` that runs before the copy to the host."""
    return (torch.clamp(fb[:3].permute(1, 2, 0), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def framebuffer_to_image(fb, flip_y: bool = True) -> np.ndarray:
    """Planar (3, H, W) float framebuffer (tensor or array) → (H, W, 3)
    uint8. ``flip_y`` puts the top image row (NDC y = +1) first. Tensors
    convert on their own device, so only 3 bytes per pixel are copied."""
    if isinstance(fb, torch.Tensor):
        img = framebuffer_to_uint8(fb).cpu().numpy()
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
