"""Plain PyTorch reference of one 3D Gaussian Splatting frame.

The renderer this repository implements, written out directly: a
look-at pinhole camera, spherical-harmonics colour (the real basis of
Kerbl et al. 2023 up to degree 3, offset by ½ and clamped to [0, 1]),
the EWA projection Σ₂ = J·W·Σ₃·Wᵀ·Jᵀ with Σ₃ = R·S·Sᵀ·Rᵀ, a k-σ pixel
box, and per-tile front-to-back compositing in exact depth order:

    alpha = min(opacity · exp(−½·md²), 0.99)   inside the box, else 0
    alpha < 1e-3 is skipped; a pixel takes alpha·T while T ≥ 1e-3

with md² = A·dx² + B·dx·dy + C·dy² at integer pixel coordinates. Every
step runs in one :class:`Precision` (float32 with TF32 off by default),
so that the same code computed in a lower precision is the benchmark's
control. Nothing here comes from the program under test.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
ALPHA_MIN = 1e-3
ALPHA_MAX = 0.99
T_MIN = 1e-3
#: Determinant below which a projected splat is dropped (px⁴).
DET_MIN = 1e-8
#: NDC margin of the on-screen test of a splat's box.
SCREEN_EDGE = 0.99
#: Lanes of a tile composited together.
CHUNK = 256


class Precision(NamedTuple):
    """The arithmetic a reference computation runs in: ``dtype`` for every
    tensor, and with ``tf32`` the operands of each matrix product and
    convolution rounded to TF32's 10-bit mantissa first, which is what the
    tensor cores do with float32 when TF32 is on (written out, so that the
    same numbers come on any device)."""

    dtype: torch.dtype = torch.float32
    tf32: bool = False

    @contextlib.contextmanager
    def active(self):
        """Keeps the card's own TF32 off while open: products run in the
        precision asked for and no other."""
        mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a matrix product or convolution takes it."""
        if not self.tf32 or x.dtype != torch.float32:
            return x
        bits = x.contiguous().view(torch.int32)
        rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return x + (rounded - x).detach()


FP32 = Precision()


def look_at(position, target, fov_y_deg: float, aspect: float, near: float, far: float,
            k_sigma: float = 3.0, up=(0.0, 1.0, 0.0)) -> dict:
    """A pinhole camera at ``position`` looking at ``target`` (OpenGL
    convention: the camera looks down its −z axis), in float64."""
    pos = np.asarray(position, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    upv = np.cross(right, fwd)
    rot = np.stack([right, upv, -fwd])  # world → camera rows
    fy = 1.0 / math.tan(math.radians(fov_y_deg) / 2.0)
    return dict(rot=rot, trans=-rot @ pos, position=pos, fx=fy / aspect, fy=fy,
                near=float(near), far=float(far), k_sigma=float(k_sigma))


def activate(params: dict) -> dict:
    """Trainable parameters → the renderer's (opacity and scale activated)."""
    return dict(positions=params["positions"], sh=params["sh"],
                opacity=torch.sigmoid(params["raw_opacity"]),
                scales=torch.exp(params["raw_scales"]), quats=params["quats"])


def sh_color(sh: torch.Tensor, d: torch.Tensor, degree: int) -> torch.Tensor:
    """(N, 3) colour of interleaved SH coefficients ``sh`` (N, 3·k) along
    unit directions ``d`` (N, 3)."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
                  SH_C2[3] * x * z, SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                  SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3 * yy)]
    coeffs = sh[:, :3 * len(basis)].reshape(sh.shape[0], len(basis), 3)
    color = (torch.cat(basis, 1)[:, :, None] * coeffs).sum(1)
    return torch.clamp(color + 0.5, 0.0, 1.0)


def quat_rotation(q: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations of w, x, y, z quaternions (normalized here)."""
    n = torch.linalg.vector_norm(q, dim=1, keepdim=True)
    q = q / torch.where(n > 0, n, torch.ones_like(n))
    w, x, y, z = q.unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], 1).reshape(-1, 3, 3)


class Projected(NamedTuple):
    """Per-splat screen quantities."""

    valid: torch.Tensor  # (N,) bool
    depth: torch.Tensor  # (N,) camera distance along the view axis
    feat: torch.Tensor  # (N, 9): cx, cy, A, B, C, opacity, r, g, b
    box: torch.Tensor  # (N, 4) pixel box xmin, ymin, xmax, ymax (inclusive)


def project(scene: dict, cam: dict, width: int, height: int, sh_degree: int,
            round_centers: bool, prec: Precision = FP32) -> Projected:
    """Every splat of ``scene`` (activated, any float dtype) through ``cam``."""
    dt, dev = prec.dtype, scene["positions"].device

    def c(x):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    pos = scene["positions"].to(dt)
    rot, trans = c(cam["rot"]), c(cam["trans"])
    mm = prec.operand
    pc = mm(pos) @ mm(rot.T) + trans
    cx, cy, cz = pc.unbind(1)
    near, far = cam["near"], cam["far"]
    ndc_x = cam["fx"] * cx / -cz
    ndc_y = cam["fy"] * cy / -cz
    ndc_z = ((far + near) / (near - far) * cz + 2 * far * near / (near - far)) / -cz

    d = pos - c(cam["position"])
    dn = torch.linalg.vector_norm(d, dim=1, keepdim=True)
    color = sh_color(scene["sh"].to(dt), d / torch.where(dn > 1e-8, dn, torch.ones_like(dn)),
                     sh_degree)

    rs = quat_rotation(scene["quats"].to(dt)) * scene["scales"].to(dt)[:, None, :]
    cov3 = mm(rs) @ mm(rs.transpose(1, 2))
    safe_z = torch.where(cz.abs() > 1e-12, cz, torch.full_like(cz, 1e-12))
    zero = torch.zeros_like(cz)
    jac = torch.stack([cam["fx"] / safe_z, zero, -cam["fx"] * cx / safe_z ** 2,
                       zero, cam["fy"] / safe_z, -cam["fy"] * cy / safe_z ** 2],
                      1).reshape(-1, 2, 3)
    t = mm(jac) @ mm(rot)
    cov2 = (mm(t) @ mm(cov3)) @ mm(t.transpose(1, 2))
    sxx = cov2[:, 0, 0] * (width * width / 4)
    sxy = cov2[:, 0, 1] * (width * height / 4)
    syy = cov2[:, 1, 1] * (height * height / 4)
    det = sxx * syy - sxy * sxy
    det_ok = torch.isfinite(det) & (det >= DET_MIN)
    inv = 1 / torch.where(det_ok, det, torch.ones_like(det))
    px = (ndc_x + 1) * (width / 2)
    py = (ndc_y + 1) * (height / 2)
    if round_centers:
        px, py = torch.round(px), torch.round(py)
    opacity = scene["opacity"].to(dt)
    feat = torch.stack([px, py, syy * inv, -2 * sxy * inv, sxx * inv, opacity,
                        color[:, 0], color[:, 1], color[:, 2]], 1)

    with torch.no_grad():
        # The k-σ box of the ellipse's principal axes, in NDC.
        tr, dif = sxx + syy, sxx - syy
        rad = torch.sqrt(torch.clamp_min(dif * dif + 4 * sxy * sxy, 0))
        r1 = cam["k_sigma"] * torch.sqrt(torch.clamp_min((tr + rad) / 2, 1e-8))
        r2 = cam["k_sigma"] * torch.sqrt(torch.clamp_min((tr - rad) / 2, 1e-8))
        th = torch.atan2(2 * sxy, dif) / 2
        ex = ((r1 * torch.cos(th)).abs() + (r2 * torch.sin(th)).abs()) / (width / 2)
        ey = ((r1 * torch.sin(th)).abs() + (r2 * torch.cos(th)).abs()) / (height / 2)
        x0, x1, y0, y1 = ndc_x - ex, ndc_x + ex, ndc_y - ey, ndc_y + ey
        on_screen = (x1 >= -SCREEN_EDGE) & (x0 <= SCREEN_EDGE) & (y1 >= -SCREEN_EDGE) & (
            y0 <= SCREEN_EDGE)
        box = torch.stack([
            torch.floor((torch.clamp_min(x0, -1) + 1) * (width / 2)),
            torch.floor((torch.clamp_min(y0, -1) + 1) * (height / 2)),
            torch.ceil((torch.clamp_max(x1, 1) + 1) * (width / 2)),
            torch.ceil((torch.clamp_max(y1, 1) + 1) * (height / 2)),
        ], 1)
        ndc = torch.stack([ndc_x, ndc_y, ndc_z], 1)
        finite = torch.isfinite(pc).all(1) & torch.isfinite(ndc).all(1)
        valid = (finite & (cz < -near) & (ndc_z >= -1) & (ndc_z <= 1) & det_ok & on_screen
                 & torch.isfinite(feat).all(1))
    return Projected(valid=valid, depth=-cz, feat=feat, box=box)


def project_for_gradients(params: dict, cam: dict, width: int, height: int,
                          sh_degree: int, prec: Precision = FP32) -> Projected:
    """:func:`project` of trainable parameters whose gradient reaches only
    the splats that are drawn: the rest are replaced by a constant splat
    before the differentiable pass, so no arithmetic of theirs (a NaN
    parameter, a splat at the camera) reaches the parameters."""
    with torch.no_grad():
        valid = project(activate(params), cam, width, height, sh_degree, False, prec).valid
    safe = dict(positions=(0.0, 0.0, 0.0), raw_opacity=0.0, raw_scales=(-5.0,) * 3,
                quats=(1.0, 0.0, 0.0, 0.0))
    kept = {}
    for name, p in params.items():
        fill = torch.zeros_like(p[:1]) if name == "sh" else torch.as_tensor(
            safe[name], dtype=p.dtype, device=p.device).expand_as(p[:1])
        mask = valid.reshape((-1,) + (1,) * (p.dim() - 1))
        kept[name] = torch.where(mask, p, fill)
    proj = project(activate(kept), cam, width, height, sh_degree, False, prec)
    return proj._replace(valid=valid)


class Instances(NamedTuple):
    """(splat, tile) pairs sorted by tile, then depth, then splat."""

    splat: torch.Tensor  # (C,) int64
    tile_start: torch.Tensor  # (T,) int64
    tile_count: torch.Tensor  # (T,) int64


def tile_instances(proj: Projected, tile_w: int, tile_h: int, tiles_x: int,
                   tiles_y: int) -> Instances:
    """Every tile each drawn splat's box touches, in front-to-back order."""
    dev = proj.valid.device
    ids = torch.nonzero(proj.valid).squeeze(1)
    box = proj.box[ids].to(torch.float32).to(torch.int64)
    tx0 = torch.clamp(torch.div(box[:, 0], tile_w, rounding_mode="floor"), 0, tiles_x - 1)
    ty0 = torch.clamp(torch.div(box[:, 1], tile_h, rounding_mode="floor"), 0, tiles_y - 1)
    tx1 = torch.clamp(torch.div(box[:, 2], tile_w, rounding_mode="floor"), 0, tiles_x - 1)
    ty1 = torch.clamp(torch.div(box[:, 3], tile_h, rounding_mode="floor"), 0, tiles_y - 1)
    w, h = tx1 - tx0 + 1, ty1 - ty0 + 1
    area = w * h
    owner = torch.repeat_interleave(torch.arange(ids.numel(), device=dev), area)
    k = torch.arange(owner.numel(), device=dev) - (torch.cumsum(area, 0) - area)[owner]
    row = torch.div(k, w[owner], rounding_mode="floor")
    tile = (tx0[owner] + k % w[owner]) + (ty0[owner] + row) * tiles_x
    # Depth is positive, so its float32 bits order as the depths do.
    depth_bits = proj.depth.detach()[ids].to(torch.float32).contiguous().view(torch.int32)
    key = tile * (1 << 32) + depth_bits[owner].to(torch.int64)
    order = torch.sort(key, stable=True).indices
    count = torch.bincount(tile, minlength=tiles_x * tiles_y)
    return Instances(splat=ids[owner[order]], tile_start=torch.cumsum(count, 0) - count,
                     tile_count=count)


class Geometry(NamedTuple):
    width: int
    height: int
    tile_w: int
    tile_h: int

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)


def composite(feat: torch.Tensor, box: torch.Tensor, inst: Instances, geo: Geometry,
              tiles: torch.Tensor, prec: Precision = FP32, pairs: Optional[list] = None):
    """Front-to-back compositing of ``tiles`` (1-D int64): returns their
    (len(tiles), 3, tile_h·tile_w) colour blocks. Differentiable in
    ``feat``. With ``pairs`` (a list), appends the number of pixel ×
    instance pairs that blend: the pixel in the image and still open
    (T ≥ 1e-3), inside the splat's box, alpha ≥ 1e-3."""
    dt, dev = prec.dtype, feat.device
    tw, th = geo.tile_w, geo.tile_h
    n, p = tiles.numel(), tw * th
    pix = torch.arange(p, device=dev)
    gx = (tiles % geo.tiles_x * tw)[:, None] + (pix % tw)[None, :]
    gy = (torch.div(tiles, geo.tiles_x, rounding_mode="floor") * th)[:, None] + (pix // tw)[None, :]
    in_img = (gx < geo.width) & (gy < geo.height)
    gx, gy = gx.to(dt), gy.to(dt)
    start, count = inst.tile_start[tiles], inst.tile_count[tiles]
    lanes = torch.arange(CHUNK, device=dev)
    trans = torch.ones((n, p), dtype=dt, device=dev)
    acc = torch.zeros((n, p, 3), dtype=dt, device=dev)
    feat, box = feat.to(dt), box.to(dt)
    n_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    live = torch.nonzero(count > 0).squeeze(1)
    step = 0
    while live.numel():
        k = step * CHUNK + lanes
        lane_ok = k[None, :] < count[live, None]
        slot = torch.clamp(start[live, None] + k[None, :], max=max(inst.splat.numel() - 1, 0))
        s = inst.splat[slot]
        f, b = feat[s], box[s]  # (L, K, 9), (L, K, 4)
        x, y = gx[live][:, :, None], gy[live][:, :, None]
        dx, dy = x - f[:, None, :, 0], y - f[:, None, :, 1]
        md2 = f[:, None, :, 2] * dx * dx + f[:, None, :, 3] * dx * dy + f[:, None, :, 4] * dy * dy
        alpha = torch.clamp_max(f[:, None, :, 5] * torch.exp(-0.5 * md2), ALPHA_MAX)
        inside = ((x >= b[:, None, :, 0]) & (x <= b[:, None, :, 2]) & (y >= b[:, None, :, 1])
                  & (y <= b[:, None, :, 3]) & lane_ok[:, None, :])
        hit = inside & (alpha >= ALPHA_MIN)
        alpha = torch.where(hit, alpha, torch.zeros_like(alpha))
        t_in = trans[live]
        t_after = t_in[:, :, None] * torch.cumprod(1 - alpha, 2)
        t_before = torch.cat([t_in[:, :, None], t_after[:, :, :-1]], 2)
        open_ = t_before >= T_MIN
        weight = torch.where(open_, alpha * t_before, torch.zeros_like(alpha))
        if pairs is not None:
            n_pairs += (hit & open_ & in_img[live][:, :, None]).sum()
        color = torch.bmm(prec.operand(weight), prec.operand(f[:, :, 6:9]))
        acc = acc.index_copy(0, live, acc[live] + color)
        t_new = t_in * torch.prod(torch.where(open_, 1 - alpha, torch.ones_like(alpha)), 2)
        trans = trans.index_copy(0, live, t_new)
        step += 1
        more = (step * CHUNK < count[live]) & (t_new.amax(1) >= T_MIN)
        live = live[more]
    if pairs is not None:
        pairs.append(int(n_pairs))
    return acc.transpose(1, 2)


def assemble(blocks: torch.Tensor, tiles: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """Tile blocks (len(tiles), 3, P) → a planar (3, H, W) image (tiles
    not given stay 0); row y is pixel row y (NDC y = −1 first)."""
    full = blocks.new_zeros((geo.tiles_x * geo.tiles_y, 3, geo.tile_h * geo.tile_w))
    full = full.index_copy(0, tiles, blocks)
    img = full.reshape(geo.tiles_y, geo.tiles_x, 3, geo.tile_h, geo.tile_w)
    img = img.permute(2, 0, 3, 1, 4).reshape(3, geo.tiles_y * geo.tile_h, geo.tiles_x * geo.tile_w)
    return img[:, :geo.height, :geo.width]


def render(scene: dict, cam: dict, geo: Geometry, sh_degree: int, round_centers: bool,
           prec: Precision = FP32, counts: Optional[dict] = None,
           tile_group: int = 512) -> torch.Tensor:
    """A (3, H, W) float32 frame of an activated ``scene``; tiles are
    composited ``tile_group`` at a time to bound memory. ``counts``, a
    dict, gets the frame's ``instances`` and blending ``pairs``."""
    pairs = None if counts is None else []
    with prec.active(), torch.no_grad():
        proj = project(scene, cam, geo.width, geo.height, sh_degree, round_centers, prec)
        inst = tile_instances(proj, geo.tile_w, geo.tile_h, geo.tiles_x, geo.tiles_y)
        all_tiles = torch.arange(geo.tiles_x * geo.tiles_y, device=proj.feat.device)
        blocks = torch.cat([composite(proj.feat, proj.box, inst, geo, all_tiles[i:i + tile_group],
                                      prec, pairs)
                            for i in range(0, all_tiles.numel(), tile_group)])
        if counts is not None:
            counts.update(pairs=sum(pairs), instances=int(inst.splat.numel()))
        return assemble(blocks, all_tiles, geo).to(torch.float32)

