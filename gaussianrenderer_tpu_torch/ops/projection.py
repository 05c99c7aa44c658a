"""Per-Gaussian preprocessing: cull + SH color + EWA projection (PyTorch port).

Counterpart of ``gaussianrenderer_tpu.ops.projection``; see its module
docstring for the reference math. Every Gaussian keeps its slot and
carries a validity mask. The arithmetic follows the JAX version operation
for operation on float32 (N,) columns, so the integer outputs (``valid``,
the pixel AABB, the rounded centers, the tile rects) come out bit-equal.
Float→int conversions saturate like XLA's instead of relying on the
host's undefined behaviour for NaN and out-of-range values.

Gradients: autograd reaches the fields the JAX package differentiates
(color, center, conic, opacity, depth). The pixel AABB and tile rect end
in floors, integer casts and masks, which carry no gradient there; here
they are computed without autograd, so torch never multiplies a zero
cotangent by an infinite local derivative (a square root of 0, atan2 at
the origin) into NaN. And an invalid splat gets exactly zero gradient in
every input, as culled splats do in the reference rasterizer: its
features are never composited, but its own arithmetic may be non-finite
(a NaN parameter, a splat at the camera), and 0·NaN would reach the
parameters. Neither changes a forward value.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from gaussianrenderer_tpu_torch.ops.cuda.sh_color import sh_color
from gaussianrenderer_tpu_torch.ops.sh import sqrt_f32
from gaussianrenderer_tpu_torch.scene.camera import CameraParams
from gaussianrenderer_tpu_torch.scene.gaussians import GaussianScene

#: Blend threshold: a pixel contributes only when alpha ≥ ALPHA_EPS. The
#: coverage bound below, the emission prune and the compositor share it.
ALPHA_EPS = 1e-3


class ProjectedGaussians(NamedTuple):
    """Per-Gaussian screen-space quantities (all leading dim N)."""

    valid: torch.Tensor  # (N,) bool — survives cull + det + AABB checks
    depth: torch.Tensor  # (N,) float32, −Z in camera space
    color: torch.Tensor  # (N, 3) SH-evaluated RGB in [0,1]
    opacity: torch.Tensor  # (N,)
    center_px: torch.Tensor  # (N, 2) float32 rounded pixel center (x, y)
    conic: torch.Tensor  # (N, 3) (A, B, C): md² = A·dx² + B·dx·dy + C·dy²
    aabb_px: torch.Tensor  # (N, 4) float32 (xmin, ymin, xmax, ymax) pixels
    tile_min: torch.Tensor  # (N, 2) int32 inclusive tile range (x, y)
    tile_max: torch.Tensor  # (N, 2) int32


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32, truncating toward zero like XLA's convert: NaN
    becomes 0 and values beyond the int32 range saturate. Callers clip
    the result to small ranges, so saturating at ±2^30 is equivalent."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-(2.0**30), 2.0**30)
    return x.to(torch.int32)


class _KeepRows(torch.autograd.Function):
    """Identity whose backward zeroes the gradient rows (leading axis)
    where ``rows.mask`` is False; the mask is set after the forward."""

    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mask = ctx.rows.mask.reshape((-1,) + (1,) * (grad.dim() - 1))
        return torch.where(mask, grad, 0.0), None


class _ValidRows:
    """Passes each input through :class:`_KeepRows`, then takes the mask
    of valid splats once the projection knows it."""

    def __init__(self):
        self.mask = None

    def __call__(self, x):
        if x is None or not (x.requires_grad and torch.is_grad_enabled()):
            return x
        return _KeepRows.apply(x, self)


def slice_spacetime(scene: GaussianScene, time_value):
    """4D spacetime-Gaussian time slicing: returns ``(scene',
    extra_opacity)`` for rendering at ``time_value``.

    ``time_params`` (N, 2) gives temporal opacity only; (N, 5) adds a
    velocity and positions are sliced ``p(t) = p + v·(t − t_center)``.
    A static scene or ``time_value=None`` returns the scene unchanged
    with ``extra_opacity=None``.
    """
    if scene.time_params is None or time_value is None:
        return scene, None
    tp = scene.time_params.to(torch.float32).T  # (2|5, N)
    dt = time_value - tp[0]
    t_sigma = torch.clamp_min(tp[1], 1e-6)
    u = dt / t_sigma
    extra_opacity = torch.exp(-0.5 * u * u)
    if tp.shape[0] >= 5:
        delta = tp[2:5] * dt[None, :]  # (3, N)
        scene = scene._replace(positions=scene.positions + delta.T)
    return scene, extra_opacity


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(N,4) w,x,y,z quaternions → (N,3,3) rotations."""
    q = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def preprocess_gaussians(
    scene: GaussianScene,
    cam: CameraParams,
    *,
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    tiles_x: int,
    tiles_y: int,
    sh_degree: int = 2,
    extra_opacity_scale: Optional[torch.Tensor] = None,
    quantize_centers: bool = True,
    ewa_dilation: float = 0.0,
    ewa_compensate: bool = False,
    ndc_probe: Optional[torch.Tensor] = None,
) -> ProjectedGaussians:
    """Vectorized cull + color + EWA projection for all N Gaussians.

    ``extra_opacity_scale`` is an optional (N,) multiplier on opacities
    (the 4D time slice's temporal opacity). ``ndc_probe`` is an optional
    (2, N) all-zeros tensor added to the NDC center: it changes nothing,
    and its gradient is dL/d(NDC center), the view-space positional
    gradient adaptive density control keys on.
    """
    f32 = torch.float32
    rows = _ValidRows()
    pos = rows(scene.positions).to(f32)
    pos_t = pos.T  # (3, N)
    quat_t = rows(scene.quats).to(f32).T  # (4, N)
    scale_t = rows(scene.scales).to(f32).T  # (3, N)
    px_, py_, pz_ = pos_t[0], pos_t[1], pos_t[2]

    # ------------------------------------------------ SH view-dependent color
    color = sh_color(pos, rows(scene.sh), cam.position, sh_degree)

    # --------------------------------------------- view + projection transform
    view = cam.view.to(f32)
    cx = view[0, 0] * px_ + view[0, 1] * py_ + view[0, 2] * pz_ + view[0, 3]
    cy = view[1, 0] * px_ + view[1, 1] * py_ + view[1, 2] * pz_ + view[1, 3]
    cz = view[2, 0] * px_ + view[2, 1] * py_ + view[2, 2] * pz_ + view[2, 3]

    proj = cam.proj.to(f32)
    clip_x = proj[0, 0] * cx
    clip_y = proj[1, 1] * cy
    clip_z = proj[2, 2] * cz + proj[2, 3]
    clip_w = -cz
    safe_w = torch.where(torch.abs(clip_w) > 1e-12, clip_w, 1e-12)
    ndc_x = clip_x / safe_w
    ndc_y = clip_y / safe_w
    ndc_z = clip_z / safe_w
    if ndc_probe is not None:
        probe = rows(ndc_probe.T).T
        ndc_x = ndc_x + probe[0]
        ndc_y = ndc_y + probe[1]

    finite_cam = torch.isfinite(cx) & torch.isfinite(cy) & torch.isfinite(cz)
    finite_ndc = (
        torch.isfinite(ndc_x) & torch.isfinite(ndc_y) & torch.isfinite(ndc_z)
    )
    in_front = cz < -cam.near
    z_ok = (ndc_z >= -1.0) & (ndc_z <= 1.0)
    survived_cull = finite_cam & finite_ndc & in_front & z_ok

    depth = -cz

    # ------------------------------------------------------- EWA Σ2D projection
    fy = 1.0 / torch.tan(cam.fov_y.to(f32) * (math.pi / 180.0) * 0.5)
    fx = fy / cam.aspect
    safe_z = torch.where(torch.abs(cz) > 1e-12, cz, 1e-12)
    inv_z = 1.0 / safe_z
    j00 = fx * inv_z
    j02 = -fx * cx * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * cy * inv_z * inv_z

    qw, qx, qy, qz = quat_t[0], quat_t[1], quat_t[2], quat_t[3]
    qn = sqrt_f32(qw * qw + qx * qx + qy * qy + qz * qz)
    qi = torch.where(qn > 0, 1.0 / qn, 0.0)
    qw, qx, qy, qz = qw * qi, qx * qi, qy * qi, qz * qi
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)

    # Σ3D = R·diag(s²)·Rᵀ, expanded on columns.
    s0 = torch.square(scale_t[0])
    s1 = torch.square(scale_t[1])
    s2_ = torch.square(scale_t[2])
    c00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2_
    c01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2_
    c02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2_
    c11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2_
    c12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2_
    c22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2_

    # Rotate to the camera frame: M = R_cam · Σ · R_camᵀ.
    rc = cam.r_cam.to(f32)
    t00 = rc[0, 0] * c00 + rc[0, 1] * c01 + rc[0, 2] * c02
    t01 = rc[0, 0] * c01 + rc[0, 1] * c11 + rc[0, 2] * c12
    t02 = rc[0, 0] * c02 + rc[0, 1] * c12 + rc[0, 2] * c22
    t10 = rc[1, 0] * c00 + rc[1, 1] * c01 + rc[1, 2] * c02
    t11 = rc[1, 0] * c01 + rc[1, 1] * c11 + rc[1, 2] * c12
    t12 = rc[1, 0] * c02 + rc[1, 1] * c12 + rc[1, 2] * c22
    t20 = rc[2, 0] * c00 + rc[2, 1] * c01 + rc[2, 2] * c02
    t21 = rc[2, 0] * c01 + rc[2, 1] * c11 + rc[2, 2] * c12
    t22 = rc[2, 0] * c02 + rc[2, 1] * c12 + rc[2, 2] * c22
    m00 = t00 * rc[0, 0] + t01 * rc[0, 1] + t02 * rc[0, 2]
    m01 = t00 * rc[1, 0] + t01 * rc[1, 1] + t02 * rc[1, 2]
    m02 = t00 * rc[2, 0] + t01 * rc[2, 1] + t02 * rc[2, 2]
    m11 = t10 * rc[1, 0] + t11 * rc[1, 1] + t12 * rc[1, 2]
    m12 = t10 * rc[2, 0] + t11 * rc[2, 1] + t12 * rc[2, 2]
    m22 = t20 * rc[2, 0] + t21 * rc[2, 1] + t22 * rc[2, 2]

    # Σ2D = J·Σcam·Jᵀ with J rows [j00, 0, j02], [0, j11, j12].
    u00 = j00 * m00 + j02 * m02
    u02 = j00 * m02 + j02 * m22
    u10 = j11 * m01 + j12 * m02
    u11 = j11 * m11 + j12 * m12
    u12 = j11 * m12 + j12 * m22
    sxx_ndc = u00 * j00 + u02 * j02
    sxy_ndc = u10 * j00 + u12 * j02
    syy_ndc = u11 * j11 + u12 * j12

    half_w = width * 0.5
    half_h = height * 0.5
    sxx = sxx_ndc * (half_w * half_w) + ewa_dilation
    sxy = sxy_ndc * (half_w * half_h)
    syy = syy_ndc * (half_h * half_h) + ewa_dilation

    # Analytic inverse with the det < 1e-8 (and NaN) rejection.
    det = sxx * syy - sxy * sxy
    det_ok = torch.isfinite(det) & (det >= 1e-8)
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    conic_a = syy * inv_det
    conic_b = -2.0 * sxy * inv_det
    conic_c = sxx * inv_det

    cx_px = (ndc_x + 1.0) * 0.5 * width
    cy_px = (ndc_y + 1.0) * 0.5 * height
    if quantize_centers:
        cx_px = torch.round(cx_px)
        cy_px = torch.round(cy_px)

    opacity = rows(scene.opacity).to(f32)
    if extra_opacity_scale is not None:
        opacity = opacity * rows(extra_opacity_scale)
    if ewa_compensate and ewa_dilation > 0.0:
        det0 = (sxx - ewa_dilation) * (syy - ewa_dilation) - sxy * sxy
        opacity = opacity * sqrt_f32(torch.clamp_min(det0, 0.0) * inv_det)

    # The pixel AABB and the tile rect feed only floors, integer casts and
    # masks: computed without autograd (module docstring).
    with torch.no_grad():
        # Closed-form eigenvalues + angle → k-sigma axis-aligned extents.
        tr = sxx + syy
        dif = sxx - syy
        rad = sqrt_f32(torch.clamp_min(dif * dif + 4.0 * sxy * sxy, 0.0))
        lam1 = torch.clamp_min(0.5 * (tr + rad), 1e-8)
        lam2 = torch.clamp_min(0.5 * (tr - rad), 1e-8)
        theta = 0.5 * torch.atan2(2.0 * sxy, dif)
        r1 = cam.k_sigma * sqrt_f32(lam1)
        r2 = cam.k_sigma * sqrt_f32(lam2)
        c_t = torch.cos(theta)
        s_t = torch.sin(theta)
        ex = (torch.abs(r1 * c_t) + torch.abs(r2 * s_t)) / half_w
        ey = (torch.abs(r1 * s_t) + torch.abs(r2 * c_t)) / half_h

        xmin = ndc_x - ex
        xmax = ndc_x + ex
        ymin = ndc_y - ey
        ymax = ndc_y + ey
        on_screen = ~(
            (xmax < -0.99) | (xmin > 0.99) | (ymax < -0.99) | (ymin > 0.99)
        )

        xmin = torch.clamp_min(xmin, -1.0)
        xmax = torch.clamp_max(xmax, 1.0)
        ymin = torch.clamp_min(ymin, -1.0)
        ymax = torch.clamp_max(ymax, 1.0)

        # Floor the low edges and ceil the high ones.
        xmin_px = torch.floor((xmin + 1.0) * 0.5 * width)
        xmax_px = torch.ceil((xmax + 1.0) * 0.5 * width)
        ymin_px = torch.floor((ymin + 1.0) * 0.5 * height)
        ymax_px = torch.ceil((ymax + 1.0) * 0.5 * height)

        # Threshold-ellipse coverage bound: alpha ≥ ALPHA_EPS needs
        # md² ≤ gain = 2·ln(op/ε), whose exact pixel extent is ±√(gain·Σxx);
        # the emitted AABB is its intersection with the k·σ box (margins as
        # in the JAX version).
        gain = 2.0 * torch.log((opacity + 1e-4) * (1.0 / ALPHA_EPS))
        gain = torch.clamp_min(gain, 0.0) * (1.0 + 2.0**-6)
        ext_x = sqrt_f32(gain * torch.clamp_min(sxx, 0.0)) + 1.0
        ext_y = sqrt_f32(gain * torch.clamp_min(syy, 0.0)) + 1.0
        xmin_px = torch.maximum(xmin_px, torch.floor(cx_px - ext_x))
        xmax_px = torch.minimum(xmax_px, torch.ceil(cx_px + ext_x))
        ymin_px = torch.maximum(ymin_px, torch.floor(cy_px - ext_y))
        ymax_px = torch.minimum(ymax_px, torch.ceil(cy_px + ext_y))
        nonempty = (xmax_px >= xmin_px) & (ymax_px >= ymin_px)

    valid = survived_cull & det_ok & on_screen & nonempty
    rows.mask = valid

    # Tile coverage via integer (floor) stride division.
    tmin_x = torch.clamp(to_int32(xmin_px) // tile_w, 0, tiles_x - 1)
    tmax_x = torch.clamp(to_int32(xmax_px) // tile_w, 0, tiles_x - 1)
    tmin_y = torch.clamp(to_int32(ymin_px) // tile_h, 0, tiles_y - 1)
    tmax_y = torch.clamp(to_int32(ymax_px) // tile_h, 0, tiles_y - 1)

    return ProjectedGaussians(
        valid=valid,
        depth=depth,
        color=color,
        opacity=opacity,
        center_px=torch.stack([cx_px, cy_px], dim=-1),
        conic=torch.stack([conic_a, conic_b, conic_c], dim=-1),
        aabb_px=torch.stack([xmin_px, ymin_px, xmax_px, ymax_px], dim=-1),
        tile_min=torch.stack([tmin_x, tmin_y], dim=-1).to(torch.int32),
        tile_max=torch.stack([tmax_x, tmax_y], dim=-1).to(torch.int32),
    )
