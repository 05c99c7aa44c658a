"""Spherical-harmonics view-dependent color (PyTorch port).

Counterpart of ``gaussianrenderer_tpu.ops.sh``: the real SH basis up to
degree 3, view direction = normalize(splat_pos − camera_pos), result
offset by +0.5 and clamped to [0, 1]. The operation order matches the
JAX version term for term, so float32 results agree to rounding.
:func:`view_color` is the plain chain that ``ops/cuda/sh_color.py``
runs on the CPU and holds its kernel to on the card.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. torch's vectorized CPU sqrt
    can land an ulp off; a float64 root rounded to float32 is exact
    (53 ≥ 2·24 + 2 bits makes the double rounding innocuous), which is
    what XLA and CUDA's sqrtf return."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def view_color(positions: torch.Tensor, sh: torch.Tensor, cam_position: torch.Tensor,
               degree: int) -> torch.Tensor:
    """(N, 3) clamped colours of splats at ``positions`` (N, 3) with
    coefficients ``sh`` (N, 3·(deg+1)²) seen from ``cam_position`` (3,),
    in float32: the direction ``normalize(pos − cam)`` (0 where the
    distance is at most 1e-8), then :func:`eval_sh_columns` to
    ``degree``."""
    f32 = torch.float32
    pos_t = positions.to(f32).T
    cpos = cam_position.to(f32)
    dx = pos_t[0] - cpos[0]
    dy = pos_t[1] - cpos[1]
    dz = pos_t[2] - cpos[2]
    norm = sqrt_f32(dx * dx + dy * dy + dz * dz)
    inv_n = torch.where(norm > 1e-8, 1.0 / norm, 0.0)
    return eval_sh_columns(sh.to(f32).T, dx * inv_n, dy * inv_n, dz * inv_n, degree)


def eval_sh_columns(
    sh_t: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    degree: int,
    clamp: bool = True,
) -> torch.Tensor:
    """Column-wise SH evaluation: ``sh_t`` is the transposed
    (3·(deg+1)², N) coefficient matrix, (x, y, z) the (N,) unit view
    direction. Returns (N, 3) colors."""
    n_coeff_stored = sh_t.shape[0] // 3
    max_degree_stored = int(round(n_coeff_stored**0.5)) - 1
    degree = min(degree, max_degree_stored)

    basis = [torch.full_like(x, SH_C0)]
    if degree > 0:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            basis += [
                SH_C2[0] * xy,
                SH_C2[1] * yz,
                SH_C2[2] * (2.0 * zz - xx - yy),
                SH_C2[3] * xz,
                SH_C2[4] * (xx - yy),
            ]
            if degree > 2:
                basis += [
                    SH_C3[0] * y * (3.0 * xx - yy),
                    SH_C3[1] * xy * z,
                    SH_C3[2] * y * (4.0 * zz - xx - yy),
                    SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                    SH_C3[4] * x * (4.0 * zz - xx - yy),
                    SH_C3[5] * z * (xx - yy),
                    SH_C3[6] * x * (xx - 3.0 * yy),
                ]
    channels = []
    for ch in range(3):
        acc = basis[0] * sh_t[ch]
        for c in range(1, len(basis)):
            acc = acc + basis[c] * sh_t[3 * c + ch]
        channels.append(acc)
    color = torch.stack(channels, dim=-1)
    if clamp:
        color = torch.clamp(color + 0.5, 0.0, 1.0)
    return color


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int,
            clamp: bool = True) -> torch.Tensor:
    """View-dependent RGB from (N, 3·(deg+1)²) interleaved coefficients at
    (N, 3) unit world directions, evaluating ``degree`` (at most the
    stored degree); ``clamp`` applies the +0.5 offset and the [0, 1]
    clamp. Returns (N, 3) colours."""
    n_coeff_stored = sh.shape[-1] // 3
    max_degree_stored = int(round(n_coeff_stored**0.5)) - 1
    degree = min(degree, max_degree_stored)

    def coeff(c: int) -> torch.Tensor:
        return sh[..., 3 * c: 3 * c + 3]

    color = SH_C0 * coeff(0)
    if degree > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        color = color - SH_C1 * y * coeff(1) + SH_C1 * z * coeff(2) - SH_C1 * x * coeff(3)
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            color = (
                color
                + SH_C2[0] * xy * coeff(4)
                + SH_C2[1] * yz * coeff(5)
                + SH_C2[2] * (2.0 * zz - xx - yy) * coeff(6)
                + SH_C2[3] * xz * coeff(7)
                + SH_C2[4] * (xx - yy) * coeff(8)
            )
            if degree > 2:
                color = (
                    color
                    + SH_C3[0] * y * (3.0 * xx - yy) * coeff(9)
                    + SH_C3[1] * xy * z * coeff(10)
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * coeff(11)
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * coeff(12)
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * coeff(13)
                    + SH_C3[5] * z * (xx - yy) * coeff(14)
                    + SH_C3[6] * x * (xx - 3.0 * yy) * coeff(15)
                )
    if clamp:
        color = torch.clamp(color + 0.5, 0.0, 1.0)
    return color
