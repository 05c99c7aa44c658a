"""Packed-instance emission: count → scan → scatter, then one key sort.

Counterpart of ``gaussianrenderer_tpu.ops.instances.build_packed_instances``.
The output is the same (5, C) u32 record layout the tile compositor
decodes (see that module's docstring for the error budget):

    row 0: tile-local center, 13.3 fixed point (16 bits per axis), or
           1-px units when the COARSE bit (row 3 bit 30) is set
    row 1: chol u | chol w     (e6m10 16-bit floats)
    row 2: chol v | opacity    (s1e6m9 | u16)
    row 3: r | g | b           (10 bits each) | COARSE << 30
    row 4: tile-local AABB     (u8 × 4: xmin | ymin<<8 | xmax<<16 | ymax<<24)

The encoders are bit-exact ports. Emission differs in mechanism, not in
result: the JAX package gives every splat a static number of lanes from
a tier ladder (TPU shapes must be static). Here every valid splat's rect
tiles are counted, an exclusive scan places them, and the exact
dead-tile test (``_tile_dead``) compacts them to the live tiles — the
same (splat, tile) set the ladder emits when it does not overflow. There
is no ladder, so nothing is truncated and ``overflow`` stays False. Tie
order inside one (tile, depth_q) key follows this emission order
(splat-major), which may differ from the ladder's: compare tie groups as
multisets.

Unsigned 32-bit fields are carried in int64 tensors while they are built
(torch lacks u32 shifts) and stored as int32 bit patterns in the packed
output, which is what the CUDA compositor reads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gaussianrenderer_tpu_torch.ops.cuda.lookup import table_lookup
from gaussianrenderer_tpu_torch.ops.projection import (
    ALPHA_EPS,
    ProjectedGaussians,
    sqrt_f32,
    to_int32,
)
from gaussianrenderer_tpu_torch.ops.sort import pack_key, sort_packed

CENTER_OFFSET = 4096.0
CENTER_SCALE = 8.0
COLOR_SCALE = 65535.0
RGB_SCALE = 1023.0
#: Screen-fixed 13.3 center carrier: q = round(c_px·8) + CQ_BIAS as u16.
CQ_BIAS = 16384
#: Tile-local rebias: row0 = q + REL_ADJ − 8·tile_origin.
REL_ADJ = int(CENTER_OFFSET * CENTER_SCALE) - CQ_BIAS
#: Conic 16-bit float window: f32 exponents [80, 143].
CONIC_EXP_BIAS = 80
#: Row-3 flag: this instance's row-0 center uses the 1-px COARSE encode.
COARSE_BIT = 1 << 30
#: Kill threshold that disables the dead-tile test.
_PRUNE_OFF = 3.0e38
#: Effective-lane histogram edges reported in ``RenderStats.area_hist``.
AREA_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192,
                256, 384, 512, 768, 1024)
#: Rects up to this many tiles count LIVE tiles in the histogram.
ENUM_AREA = 8

_U32 = 0xFFFFFFFF


class PackedInstances(NamedTuple):
    packed_feats: torch.Tensor  # (5, C) int32 bit patterns of the u32 rows
    tile_start: torch.Tensor  # (T,) int32
    tile_count: torch.Tensor  # (T,) int32
    total_instances: torch.Tensor  # () int64 — instances emitted (== C)
    overflow: torch.Tensor  # () bool — always False: nothing is truncated
    #: () bool — a center exceeded even the COARSE window and was clamped.
    center_clipped: torch.Tensor
    #: (len(AREA_BUCKETS)+1,) int64 valid-splat effective-lane histogram.
    area_hist: torch.Tensor
    #: (C,) f32 camera-space depth per sorted lane (want_depth only).
    depth_f32: Optional[torch.Tensor] = None


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values → int32 with the same bit pattern."""
    x = x & _U32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).view(torch.int32).to(torch.int64) & _U32


def _bits_f32(bits: torch.Tensor) -> torch.Tensor:
    return u32_to_i32(bits).view(torch.float32)


def _color_bits(c: torch.Tensor) -> torch.Tensor:
    q = torch.round(c * COLOR_SCALE)
    return to_int32(torch.clamp(q, 0, 65535)).to(torch.int64)


def _enc_e6m10(x: torch.Tensor) -> torch.Tensor:
    """Non-negative f32 → 16-bit e6m10 float (round-to-nearest mantissa)."""
    bits = _f32_bits(x)
    u = ((bits + 0x1000) >> 13) - (CONIC_EXP_BIAS << 10)
    return torch.clamp(u, 0, 65535)


def _dec_e6m10(e: torch.Tensor) -> torch.Tensor:
    return _bits_f32((e + (CONIC_EXP_BIAS << 10)) << 13)


def _enc_s1e6m9(x: torch.Tensor) -> torch.Tensor:
    """Signed f32 → 16-bit s1e6m9 float (sign in bit 15)."""
    bits = _f32_bits(x)
    mag = bits & 0x7FFFFFFF
    u = ((mag + 0x2000) >> 14) - (CONIC_EXP_BIAS << 9)
    mag9 = torch.clamp(u, 0, 0x7FFF)
    return mag9 | ((bits >> 31) << 15)


def _dec_s1e6m9(e: torch.Tensor) -> torch.Tensor:
    bits = (((e & 0x7FFF) + (CONIC_EXP_BIAS << 9)) << 14) | ((e >> 15) << 31)
    return _bits_f32(bits)


def _conic_chol(a, b, c):
    """Conic (A, B, C) → upper Cholesky factors (u, v, w) with
    [[A, B/2], [B/2, C]] = LᵀL, L = [[u, v], [0, w]]."""
    u = sqrt_f32(torch.clamp_min(a, 0.0))
    v = torch.where(u > 0.0, b / torch.clamp_min(2.0 * u, 1e-30), 0.0)
    w = sqrt_f32(torch.clamp_min(c - v * v, 0.0))
    return u, v, w


def _chol_conic(u, v, w):
    """Cholesky factors → conic (A, B, C) = (u², 2uv, v² + w²)."""
    return u * u, 2.0 * u * v, v * v + w * w


def _center_fields(cx, cy, tmin_x, tmin_y, rect_w, rect_h, tile_w, tile_h):
    """Per-splat center carrier: returns ``(cq, coarse, clip_flag)``.
    ``cq`` packs the 13.3 carrier, or the 1-px COARSE one when the fine
    window would clip anywhere over the splat's rect; ``clip_flag`` marks
    centers beyond even the coarse window (clamped, and reported)."""
    qxf = to_int32(torch.round(cx * CENTER_SCALE)) + CQ_BIAS
    qyf = to_int32(torch.round(cy * CENTER_SCALE)) + CQ_BIAS
    enc_max = CENTER_OFFSET - 1.0 / CENTER_SCALE
    tmax_x = (tmin_x + rect_w - 1).to(torch.float32) * tile_w
    tmax_y = (tmin_y + rect_h - 1).to(torch.float32) * tile_h
    t0x = tmin_x.to(torch.float32) * tile_w
    t0y = tmin_y.to(torch.float32) * tile_h
    fine_bad = (
        (qxf < 0) | (qxf > 65535) | (qyf < 0) | (qyf > 65535)
        | (cx - t0x > enc_max) | (cx - tmax_x < -CENTER_OFFSET)
        | (cy - t0y > enc_max) | (cy - tmax_y < -CENTER_OFFSET)
    )
    qxc = to_int32(torch.round(cx)) + CQ_BIAS
    qyc = to_int32(torch.round(cy)) + CQ_BIAS
    coarse_bad = (
        (qxc < 0) | (qxc > 65535) | (qyc < 0) | (qyc > 65535)
        | (cx - t0x > 32767.0) | (cx - tmax_x < -32768.0)
        | (cy - t0y > 32767.0) | (cy - tmax_y < -32768.0)
    )
    qx = torch.where(fine_bad, qxc, qxf)
    qy = torch.where(fine_bad, qyc, qyf)
    cq = (torch.clamp(qx, 0, 65535).to(torch.int64) << 16) | torch.clamp(
        qy, 0, 65535
    ).to(torch.int64)
    return cq, fine_bad, fine_bad & coarse_bad


def _center_q(c_px: torch.Tensor) -> torch.Tensor:
    """Screen pixel coordinate → the screen-fixed 13.3 carrier (int64 in
    [0, 65535]); exact for integer-quantized centers."""
    q = to_int32(torch.round(c_px * CENTER_SCALE)).to(torch.int64) + CQ_BIAS
    return torch.clamp(q, 0, 65535)


def _cq_decode(qx, qy, coarse):
    """Carrier ints → f32 screen pixel center, as the kernel sees it."""
    scale = torch.where(coarse, 1.0, 1.0 / CENTER_SCALE)
    cx = (qx - CQ_BIAS).to(torch.float32) * scale
    cy = (qy - CQ_BIAS).to(torch.float32) * scale
    return cx, cy


def _rgb10_bits(color: torch.Tensor) -> torch.Tensor:
    """(N, 3) [0,1] colors → r10|g10<<10|b10<<20 (row 3)."""

    def q(c):
        return to_int32(
            torch.clamp(torch.round(c * RGB_SCALE), 0, RGB_SCALE)
        ).to(torch.int64)

    return q(color[:, 0]) | (q(color[:, 1]) << 10) | (q(color[:, 2]) << 20)


def _prune_params(conic_a, conic_b, conic_c, opacity):
    """Per-Gaussian constants ``(a, b, c, pbc, pba, gain_m)`` of the exact
    dead-tile test: a tile is dead iff min md² over (tile ∩ pixel AABB)
    exceeds gain = 2·ln(op/ALPHA_EPS), kept with the JAX version's 5% +
    0.05 margin."""
    a = torch.clamp_min(conic_a, 0.0).to(torch.float32)
    c = torch.clamp_min(conic_c, 0.0).to(torch.float32)
    b = conic_b.to(torch.float32)
    pbc = b / torch.clamp_min(2.0 * c, 1e-30)
    pba = b / torch.clamp_min(2.0 * a, 1e-30)
    log_eps = torch.log(torch.tensor(ALPHA_EPS, dtype=torch.float32))
    gain = (-2.0 * log_eps).to(opacity.device) + 2.0 * torch.log(
        torch.clamp_min(opacity, 1e-12)
    )
    gain_m = torch.clamp_min(gain, 0.0) * 1.05 + 0.05
    gain_m = torch.where(torch.isfinite(gain_m), gain_m, _PRUNE_OFF)
    return (a, b, c, pbc, pba, gain_m.to(torch.float32))


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _tile_dead(prune, cx, cy, x0, y0, xmin, ymin, xmax, ymax, tile_w, tile_h):
    """Exact dead-tile test: True where min md² over the continuous rect
    (tile ∩ pixel AABB) > gain_m, so no pixel of the tile can pass the
    α ≥ ALPHA_EPS blend test. The minimum of a convex quadratic centred
    at (cx, cy) over a rect lies on a face visible from the centre, so two
    clamped edge evaluations give it exactly."""
    a, b, c, pbc, pba, gain_m = prune
    lx = torch.maximum(x0, xmin) - cx
    hx = torch.minimum(x0 + (tile_w - 1), xmax) - cx
    ly = torch.maximum(y0, ymin) - cy
    hy = torch.minimum(y0 + (tile_h - 1), ymax) - cy
    dxe = torch.where(lx > 0.0, lx, hx)
    vx = (lx > 0.0) | (hx < 0.0)
    dy1 = _clip(-pbc * dxe, ly, hy)
    mx = (a * dxe + b * dy1) * dxe + c * dy1 * dy1
    dye = torch.where(ly > 0.0, ly, hy)
    vy = (ly > 0.0) | (hy < 0.0)
    dx1 = _clip(-pba * dye, lx, hx)
    my = (a * dx1 + b * dye) * dx1 + c * dye * dye
    mn = torch.minimum(
        torch.where(vx, mx, _PRUNE_OFF), torch.where(vy, my, _PRUNE_OFF)
    )
    mn = torch.where(vx | vy, mn, 0.0)
    empty = (hx < lx) | (hy < ly)
    return empty | (mn > gain_m)


def packed_valid_np(valid, opacity):
    """The packed emitter's validity rule on host arrays: projection-valid
    and 16-bit-quantized opacity ≥ ALPHA_EPS, the population
    :func:`build_packed_instances` emits. The calibration probes
    (``parallel.strip_row_loads`` and the rect and cap probes) share it."""
    import numpy as np

    op_q = np.round(np.asarray(opacity) * COLOR_SCALE) / COLOR_SCALE
    return np.asarray(valid) & (op_q >= ALPHA_EPS)


#: u32 words per splat of the multi-device exchange record (28 B a splat,
#: where the f32 record of the ``gather32`` exchange is 22 words, 88 B).
EXCHANGE_ROWS = 7
_VALID_BIT = 1 << 30
_SAT_BIT = 1 << 31


def encode_record_rows(proj: ProjectedGaussians) -> torch.Tensor:
    """Projected splats → the quantized 28 B multi-device exchange record,
    (7, N) int64 holding u32 words (send them as ``u32_to_i32``):

      row 0: screen-fixed center, 13.3 fixed point, or 1-px COARSE units
             where the 13.3 window would clip (flagged in row 4 bit 31)
      row 1: chol u | chol w           (e6m10)
      row 2: chol v | opacity          (s1e6m9 | u16)
      row 3: r|g|b 10-bit | valid << 30 | center-saturated << 31
      row 4: pixel AABB x (xmin << 16 | xmax; bit 31 the coarse flag)
      row 5: pixel AABB y (ymin << 16 | ymax)
      row 6: camera-space depth (f32 bits, so the frame-sort key is the
             single device's)

    The same encodings as the packed sort rows, bit for bit the JAX
    package's. Tile rects do not travel: :func:`decode_record_rows`
    re-derives them from the AABB. The center-saturated bit marks a
    center beyond even the coarse window before the clip, for the
    ``center_clipped`` stat."""
    op16 = _color_bits(proj.opacity)
    ch_u, ch_v, ch_w = _conic_chol(proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2])
    ac = (_enc_e6m10(ch_u) << 16) | _enc_e6m10(ch_w)
    bop = (_enc_s1e6m9(ch_v) << 16) | op16
    cx, cy = proj.center_px[:, 0], proj.center_px[:, 1]

    def raw(c, scale):
        return to_int32(torch.round(c * scale)).to(torch.int64) + CQ_BIAS

    qx_raw, qy_raw = raw(cx, CENTER_SCALE), raw(cy, CENTER_SCALE)
    wire_coarse = (qx_raw < 0) | (qx_raw > 65535) | (qy_raw < 0) | (qy_raw > 65535)
    qxc, qyc = raw(cx, 1.0), raw(cy, 1.0)
    sat = wire_coarse & ((qxc < 0) | (qxc > 65535) | (qyc < 0) | (qyc > 65535))
    qx = torch.where(wire_coarse, torch.clamp(qxc, 0, 65535), _center_q(cx))
    qy = torch.where(wire_coarse, torch.clamp(qyc, 0, 65535), _center_q(cy))
    cq = (qx << 16) | qy
    rgbf = (
        _rgb10_bits(proj.color)
        | torch.where(proj.valid, _VALID_BIT, 0)
        | torch.where(sat, _SAT_BIT, 0)
    )

    def u16(x, hi):
        return to_int32(torch.clamp(x, 0, hi)).to(torch.int64)

    a = proj.aabb_px
    ax = (u16(a[:, 0], 32767) << 16) | u16(a[:, 2], 65535) | torch.where(
        wire_coarse, 1 << 31, 0
    )
    ay = (u16(a[:, 1], 65535) << 16) | u16(a[:, 3], 65535)
    return torch.stack([cq, ac, bop, rgbf, ax, ay, _f32_bits(proj.depth)], dim=0)


def decode_record_rows(
    rows: torch.Tensor,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
) -> Tuple[ProjectedGaussians, torch.Tensor]:
    """(7, N) exchange record (int64 u32 words) → ``(ProjectedGaussians in
    global screen coordinates, per-splat center-saturated flag)``.

    Every field decodes to the value the packed pipeline's own quantizers
    reproduce, so re-encoding is idempotent; the conic decodes as
    (u², 2uv, v² + w²), whose re-derived ``w`` may move by an ulp. Tile
    rects are re-derived from the AABB by projection's integer stride
    division."""
    cq, ac, bop, rgbf, ax, ay, dep = (rows[i] for i in range(EXCHANGE_ROWS))
    f32 = torch.float32
    valid = (rgbf & _VALID_BIT) != 0
    sat = (rgbf & _SAT_BIT) != 0
    # f32 reciprocals as tensors, so the products round as the JAX
    # package's f32 multiplies do.
    inv_rgb = torch.tensor(1.0 / RGB_SCALE, dtype=f32, device=rows.device)
    inv_op = torch.tensor(1.0 / COLOR_SCALE, dtype=f32, device=rows.device)
    color = torch.stack([((rgbf >> s) & 1023).to(f32) * inv_rgb for s in (0, 10, 20)],
                        dim=-1)
    opacity = (bop & 0xFFFF).to(f32) * inv_op
    conic = torch.stack(
        _chol_conic(_dec_e6m10(ac >> 16), _dec_s1e6m9(bop >> 16), _dec_e6m10(ac & 0xFFFF)),
        dim=-1,
    )
    wire_coarse = (ax >> 31) != 0
    cx, cy = _cq_decode(cq >> 16, cq & 0xFFFF, wire_coarse)
    xmin = (ax >> 16) & 0x7FFF
    xmax = ax & 0xFFFF
    ymin = ay >> 16
    ymax = ay & 0xFFFF
    aabb_px = torch.stack([xmin, ymin, xmax, ymax], dim=-1).to(f32)

    def tile(px, stride, count):
        return torch.clamp(px // stride, 0, count - 1)

    tx0, tx1 = tile(xmin, tile_w, tiles_x), tile(xmax, tile_w, tiles_x)
    ty0, ty1 = tile(ymin, tile_h, tiles_y), tile(ymax, tile_h, tiles_y)
    proj = ProjectedGaussians(
        valid=valid,
        depth=_bits_f32(dep),
        color=color,
        opacity=opacity,
        center_px=torch.stack([cx, cy], dim=-1),
        conic=conic,
        aabb_px=aabb_px,
        tile_min=torch.stack([tx0, ty0], dim=-1).to(torch.int32),
        tile_max=torch.stack([tx1, ty1], dim=-1).to(torch.int32),
    )
    return proj, sat


class _Prepack(NamedTuple):
    """Per-splat quantized fields, computed once and gathered per lane."""

    valid: torch.Tensor  # (N,) bool — projection-valid and op_q ≥ ALPHA_EPS
    cq: torch.Tensor  # (N,) screen-fixed center carrier
    coarse: torch.Tensor  # (N,) bool
    ac: torch.Tensor  # (N,) row 1
    bop: torch.Tensor  # (N,) row 2
    rgb: torch.Tensor  # (N,) row 3 (COARSE bit included)
    aabb: torch.Tensor  # (N, 4) int64 pixel AABB clipped to [0, 65535]
    prune: Tuple[torch.Tensor, ...]  # _prune_params of the quantized conic
    tmin_x: torch.Tensor
    tmin_y: torch.Tensor
    rect_w: torch.Tensor
    rect_h: torch.Tensor
    clip_flag: torch.Tensor  # (N,) bool


def _nscale_prepack(proj: ProjectedGaussians, *, tile_w: int, tile_h: int):
    """Per-splat pre-packing. Everything downstream (the prune and the
    compositor) reads the QUANTIZED conic and opacity, so they are
    computed once here."""
    op16 = _color_bits(proj.opacity)
    op_q = op16.to(torch.float32) * (1.0 / COLOR_SCALE)
    ch_u, ch_v, ch_w = _conic_chol(
        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2]
    )
    enc_u = _enc_e6m10(ch_u)
    enc_v = _enc_s1e6m9(ch_v)
    enc_w = _enc_e6m10(ch_w)
    ac = (enc_u << 16) | enc_w
    bop = (enc_v << 16) | op16
    rgb = _rgb10_bits(proj.color)
    aabb = to_int32(torch.clamp(proj.aabb_px, 0, 65535)).to(torch.int64)

    tmin_x = proj.tile_min[:, 0].to(torch.int64)
    tmin_y = proj.tile_min[:, 1].to(torch.int64)
    rect_w = proj.tile_max[:, 0].to(torch.int64) - tmin_x + 1
    rect_h = proj.tile_max[:, 1].to(torch.int64) - tmin_y + 1
    cq, coarse, clip_flag = _center_fields(
        proj.center_px[:, 0], proj.center_px[:, 1],
        tmin_x, tmin_y, rect_w, rect_h, tile_w, tile_h,
    )
    rgb = rgb | torch.where(coarse, COARSE_BIT, 0)
    # alpha ≤ op, so a quantized opacity below the threshold never blends.
    valid = proj.valid & (op_q >= ALPHA_EPS)
    prune = _prune_params(
        *_chol_conic(_dec_e6m10(enc_u), _dec_s1e6m9(enc_v), _dec_e6m10(enc_w)),
        op_q,
    )
    return _Prepack(
        valid, cq, coarse, ac, bop, rgb, aabb, prune,
        tmin_x, tmin_y, rect_w, rect_h, valid & clip_flag,
    )


def _eff_hist(valid: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """Count of valid splats per AREA_BUCKETS interval (prev, edge], plus
    one bucket for eff above the last edge."""
    edges = torch.tensor(AREA_BUCKETS, dtype=torch.int64, device=eff.device)
    bucket = torch.bucketize(eff[valid], edges, right=False)
    return torch.bincount(bucket, minlength=len(AREA_BUCKETS) + 1)


class _Lanes(NamedTuple):
    """One lane per (valid splat, rect tile), splat-major, with the exact
    dead-tile test of each."""

    area: torch.Tensor  # (N,) rect tiles of each valid splat, 0 otherwise
    splat: torch.Tensor  # (L,) the lane's splat
    tx: torch.Tensor  # (L,) tile column
    ty: torch.Tensor  # (L,) tile row
    qx: torch.Tensor  # (L,) 13.3 (or 1-px COARSE) center carrier, x
    qy: torch.Tensor  # (L,) and y
    co: torch.Tensor  # (L,) bool COARSE
    ab: torch.Tensor  # (L, 4) pixel AABB
    x0i: torch.Tensor  # (L,) the tile's pixel origin, x
    y0i: torch.Tensor  # (L,) and y
    dead: torch.Tensor  # (L,) bool — no pixel of the tile reaches ALPHA_EPS


def _rect_lanes(pk: _Prepack, *, tile_w: int, tile_h: int) -> _Lanes:
    """Count → exclusive scan → scatter over each valid splat's rect, then
    the exact dead-tile test on the quantized center, conic and opacity: a
    dead tile has no pixel with alpha ≥ ALPHA_EPS, so dropping it changes
    no output."""
    f32 = torch.float32
    device = pk.rect_w.device
    area = torch.where(pk.valid, pk.rect_w * pk.rect_h, 0)
    total = int(area.sum())
    splat = torch.repeat_interleave(
        torch.arange(area.shape[0], device=device), area, output_size=total
    )
    first = torch.cumsum(area, 0) - area
    pos = torch.arange(total, device=device) - first[splat]
    w = pk.rect_w[splat]
    tx = pk.tmin_x[splat] + pos % w
    ty = pk.tmin_y[splat] + pos // w

    qx = pk.cq[splat] >> 16
    qy = pk.cq[splat] & 0xFFFF
    co = pk.coarse[splat]
    cx, cy = _cq_decode(qx, qy, co)
    ab = pk.aabb[splat]
    x0i = tx * tile_w
    y0i = ty * tile_h
    dead = _tile_dead(
        tuple(p[splat] for p in pk.prune), cx, cy,
        x0i.to(f32), y0i.to(f32),
        ab[:, 0].to(f32), ab[:, 1].to(f32), ab[:, 2].to(f32), ab[:, 3].to(f32),
        tile_w, tile_h,
    )
    return _Lanes(area, splat, tx, ty, qx, qy, co, ab, x0i, y0i, dead)


def _lane_hist(valid, area, splat, live, *, tiles_x: int, tile_w: int):
    """The effective-lane histogram: live tiles for rects ≤ ENUM_AREA when
    the frame is narrow enough for the JAX package's live-tile scan, rect
    area otherwise, over the splats that emit at least one instance."""
    live_cnt = torch.zeros_like(area).index_add_(0, splat, live.to(torch.int64))
    if tiles_x * tile_w <= 4095:
        scan = valid & (area <= ENUM_AREA)
        valid_h = valid & (~scan | (live_cnt > 0))
        eff = torch.where(scan, live_cnt, area)
    else:
        valid_h, eff = valid, area
    return _eff_hist(valid_h, eff)


def _emission_probe(
    proj: ProjectedGaussians, *, tiles_x: int, tiles_y: int, tile_w: int,
    tile_h: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(area_hist, total)`` of one frame without sorting or packing:
    the histogram ``build_packed_instances`` reports and the number of
    live (splat, tile) instances it emits (its ``total_instances``), from
    the same prepack and lanes. ``tiles_y`` is the grid's, for the JAX
    signature; the rect tiles already lie inside it."""
    del tiles_y
    pk = _nscale_prepack(proj, tile_w=tile_w, tile_h=tile_h)
    lanes = _rect_lanes(pk, tile_w=tile_w, tile_h=tile_h)
    live = ~lanes.dead
    hist = _lane_hist(pk.valid, lanes.area, lanes.splat, live,
                      tiles_x=tiles_x, tile_w=tile_w)
    return hist, live.sum()


def effective_hist(
    proj: ProjectedGaussians, *, tiles_x: int, tiles_y: int, tile_w: int,
    tile_h: int,
) -> torch.Tensor:
    """The effective-lane histogram of ``stats.area_hist`` from projection
    outputs alone (prepack, lanes and the dead-tile test; no sort, no
    packing): the same code ``build_packed_instances`` runs, so the two
    are equal for the same frame."""
    return _emission_probe(proj, tiles_x=tiles_x, tiles_y=tiles_y,
                          tile_w=tile_w, tile_h=tile_h)[0]


def build_packed_instances(
    proj: ProjectedGaussians,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    near=0.1,
    far=100.0,
    want_depth: bool = False,
    depth_bits: Optional[int] = None,
    sat_cut_q: Optional[torch.Tensor] = None,
) -> PackedInstances:
    """Emit one packed record per live (splat, tile) pair, sorted by
    ``(tile << depth_bits) | depth_q``, with per-tile start and count.

    ``near``/``far`` are the camera clip planes the depth quantization
    spans (float or 0-d tensor). ``want_depth`` also decodes each sorted
    lane's camera-space depth from the key, for the depth output row.
    ``sat_cut_q`` ((num_tiles,) f32, ``satcull.tile_cutoff_q``) turns on
    the per-position saturation cull: a (splat, tile) pair whose
    quantized depth exceeds its tile's cutoff is dead like a dead tile.
    """
    device = proj.depth.device
    num_tiles = tiles_x * tiles_y
    tile_bits = max(int(num_tiles).bit_length(), 1)
    if depth_bits is None:
        depth_bits = min(32 - tile_bits, 24)
    if tile_bits + depth_bits > 32:
        raise ValueError(f"tile_bits {tile_bits} + depth_bits {depth_bits} > 32")

    pk = _nscale_prepack(proj, tile_w=tile_w, tile_h=tile_h)
    valid = pk.valid

    f32 = torch.float32
    near_t = torch.as_tensor(near, dtype=f32, device=device)
    far_t = torch.as_tensor(far, dtype=f32, device=device)
    span = torch.clamp_min(far_t - near_t, 1e-6)
    depth01 = torch.clamp((proj.depth - near_t) / span, 0.0, 1.0)
    dmax = float((1 << depth_bits) - 1)
    depth_q = torch.where(valid, depth01 * dmax, 0.0).to(torch.int64)

    # Unpacked so that the full-length lanes are freed once compacted.
    area, splat, tx, ty, qx, qy, co, ab, x0i, y0i, dead = _rect_lanes(
        pk, tile_w=tile_w, tile_h=tile_h
    )
    if sat_cut_q is not None:
        # Per-position saturation cull, folded into the dead mask before
        # the histogram (the JAX package's live scan counts these
        # positions dead too). depth_q of a valid splat is the unmasked
        # quantized depth the JAX emitter compares. The int64 tile ids go
        # to the lookup kernel as they are: it reads either width.
        cut = table_lookup(sat_cut_q, tx + ty * tiles_x,
                           r=max(-(-sat_cut_q.shape[0] // 128), 1), q=128)
        dead = dead | (depth_q[splat].to(f32) > cut)
    live = ~dead
    area_hist = _lane_hist(valid, area, splat, live, tiles_x=tiles_x, tile_w=tile_w)

    keep = torch.nonzero(live).squeeze(1)
    if keep.numel() >= 2**31:
        raise ValueError(f"{keep.numel()} instances exceed the int32 lane index")
    splat, tx, ty, qx, qy, co, ab = (
        t[keep] for t in (splat, tx, ty, qx, qy, co, ab)
    )
    x0i = x0i[keep]
    y0i = y0i[keep]

    # Per-lane tile-local center (row 0) and u8 AABB (row 4). Coarse
    # lanes subtract the tile origin in 1-px units.
    x0s = torch.where(co, x0i, x0i * int(CENTER_SCALE))
    y0s = torch.where(co, y0i, y0i * int(CENTER_SCALE))
    relx = torch.clamp(qx + REL_ADJ - x0s, 0, 65535)
    rely = torch.clamp(qy + REL_ADJ - y0s, 0, 65535)
    row0 = (relx << 16) | rely
    xmin = torch.clamp(ab[:, 0] - x0i, 0, 255)
    ymin = torch.clamp(ab[:, 1] - y0i, 0, 255)
    xmax = torch.clamp(ab[:, 2] - x0i, 0, 255)
    ymax = torch.clamp(ab[:, 3] - y0i, 0, 255)
    row4 = xmin | (ymin << 8) | (xmax << 16) | (ymax << 24)
    rows = torch.stack(
        [row0, pk.ac[splat], pk.bop[splat], pk.rgb[splat], row4], dim=0
    )

    key = pack_key(tx + ty * tiles_x, depth_q[splat], depth_bits)
    key_sorted, packed = sort_packed(key, u32_to_i32(rows))

    tile_sorted = key_sorted >> depth_bits
    count = torch.bincount(tile_sorted, minlength=num_tiles)
    start = torch.cumsum(count, 0) - count

    depth_f32 = None
    if want_depth:
        # The sat census turns these depths into cutoffs that must match
        # the JAX package's bit for bit, so this follows its jitted decode:
        # XLA divides by the constant dmax as a multiply by its f32
        # reciprocal, and contracts near + q·step into a fused
        # multiply-add. In float64 the product is exact (24-bit q, 24-bit
        # step) and so is the sum for any clip range with far/near below
        # 2^29, so one rounding to f32 gives the fused result.
        q = (key_sorted & ((1 << depth_bits) - 1)).to(torch.float64)
        step = span * (1.0 / dmax)  # the f32 reciprocal, as a scalar operand
        depth_f32 = (near_t.to(torch.float64) + q * step.to(torch.float64)).to(f32)
    return PackedInstances(
        packed_feats=packed.contiguous(),
        tile_start=start.to(torch.int32),
        tile_count=count.to(torch.int32),
        total_instances=torch.tensor(keep.numel(), device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
        center_clipped=torch.any(pk.clip_flag),
        area_hist=area_hist,
        depth_f32=depth_f32,
    )
