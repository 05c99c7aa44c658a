"""Scene editing: transform, crop, prune, merge (PyTorch port).

Counterpart of ``gaussianrenderer_tpu.scene.edit``. Every function runs on
the host in NumPy (float64 where the reference computes in float64) and
returns a new ``GaussianScene`` whose tensors lie on the input scene's
device, so both packages give bit-equal arrays.

Similarity transforms rotate the SH colour field exactly: each SH band
is closed under rotation, so the band's (2l+1)×(2l+1) rotation (the
real-basis Wigner matrix) is solved from the basis at a fixed direction
set and at the rotated directions, exact to float precision for any
degree.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gaussianrenderer_tpu_torch.ops.sh import SH_C1, SH_C2, SH_C3
from gaussianrenderer_tpu_torch.scene.colmap import rotmat2qvec
from gaussianrenderer_tpu_torch.scene.gaussians import GaussianScene
from gaussianrenderer_tpu_torch.scene.io import to_numpy as _np

#: t_sigma given to static splats merged into a spacetime scene: the
#: temporal opacity factor exp(-((t-0)/1e6)^2/2) is exactly 1.0 in f32
#: for any |t| < ~300, so such splats stay time-invariant.
STATIC_T_SIGMA = 1e6


def _band_basis(dirs: np.ndarray, l: int) -> np.ndarray:
    """Real-SH basis of band ``l`` at unit ``dirs`` (M, 3) → (M, 2l+1), in
    the coefficient order and signs of :func:`ops.sh.eval_sh`."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    if l == 1:
        cols = [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    elif l == 2:
        xx, yy, zz = x * x, y * y, z * z
        cols = [
            SH_C2[0] * x * y,
            SH_C2[1] * y * z,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * x * z,
            SH_C2[4] * (xx - yy),
        ]
    elif l == 3:
        xx, yy, zz = x * x, y * y, z * z
        cols = [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * x * y * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    else:
        raise ValueError(f"unsupported SH band {l}")
    return np.stack(cols, axis=1)


def _fibonacci_dirs(m: int) -> np.ndarray:
    """Deterministic well-spread unit directions (Fibonacci sphere)."""
    i = np.arange(m, dtype=np.float64) + 0.5
    phi = i * (np.pi * (3.0 - np.sqrt(5.0)))
    z = 1.0 - 2.0 * i / m
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def sh_band_rotation(rotation: np.ndarray, l: int) -> np.ndarray:
    """The (2l+1)×(2l+1) matrix ``X`` with ``rotated_coeffs = X @ coeffs``
    for a scene rotated by ``rotation`` (the rotated colour field is
    ``f'(d) = f(Rᵀ d)``): with ``B = Y(dᵢ)`` and ``A = Y(Rᵀ dᵢ)`` over a
    spread direction set, least squares on ``A = B·X`` recovers it."""
    r = np.asarray(rotation, np.float64)
    dirs = _fibonacci_dirs(16 * (2 * l + 1))
    b = _band_basis(dirs, l)
    a = _band_basis(dirs @ r, l)  # dirs @ r == (rᵀ · d)ᵀ row-wise
    x, *_ = np.linalg.lstsq(b, a, rcond=None)
    return x


def axis_angle_rotation(axis: Sequence[float], deg: float) -> np.ndarray:
    """Rodrigues rotation matrix (3, 3) about ``axis`` by ``deg`` degrees."""
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n == 0.0:
        raise ValueError("rotation axis must be nonzero")
    axis = axis / n
    a = np.deg2rad(deg)
    k = np.array([
        [0.0, -axis[2], axis[1]],
        [axis[2], 0.0, -axis[0]],
        [-axis[1], axis[0], 0.0],
    ])
    return np.eye(3) + np.sin(a) * k + (1.0 - np.cos(a)) * (k @ k)


def _quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product, (w, x, y, z) rows; q1 is (4,), q2 is (N, 4)."""
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2[:, 0], q2[:, 1], q2[:, 2], q2[:, 3]
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=1,
    )


def transform_scene(
    scene: GaussianScene,
    rotation: Optional[np.ndarray] = None,
    translation: Optional[Sequence[float]] = None,
    scale: float = 1.0,
) -> GaussianScene:
    """Apply the similarity transform ``p → scale·R·p + t`` to a scene:
    positions, splat orientations (quaternion composition), extents, the
    SH colour field (exactly, band by band: :func:`sh_band_rotation`) and
    spacetime velocities. The covariance becomes ``(sR)Σ(sR)ᵀ``, so the
    rendered footprint is exactly the transformed scene's."""
    r = np.eye(3) if rotation is None else np.asarray(rotation, np.float64)
    if not (np.allclose(r @ r.T, np.eye(3), atol=1e-5) and np.linalg.det(r) > 0.0):
        raise ValueError("rotation must be a proper rotation matrix (orthonormal, det +1)")
    t = np.zeros(3) if translation is None else np.asarray(translation, np.float64)
    s = float(scale)
    if s <= 0.0:
        raise ValueError(f"scale must be positive, got {s}")
    dev = scene.device

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    new_pos = s * (_np(scene.positions, np.float64) @ r.T) + t

    quats = _np(scene.quats, np.float64)
    norm = np.linalg.norm(quats, axis=1, keepdims=True)
    quats = quats / np.where(norm > 1e-12, norm, 1.0)
    new_quats = _quat_mul(rotmat2qvec(r), quats)

    sh = _np(scene.sh, np.float64)
    n_coeff = sh.shape[1] // 3
    degree = int(round(n_coeff**0.5)) - 1
    offset = 1
    for l in range(1, degree + 1):
        k = 2 * l + 1
        x = sh_band_rotation(r, l)
        band = sh[:, 3 * offset: 3 * (offset + k)].reshape(-1, k, 3)
        sh[:, 3 * offset: 3 * (offset + k)] = np.einsum("ij,njc->nic", x, band).reshape(-1, 3 * k)
        offset += k

    time_params = scene.time_params
    if time_params is not None:
        tp = _np(time_params, np.float64)
        if tp.shape[1] >= 5:
            tp[:, 2:5] = s * (tp[:, 2:5] @ r.T)
        time_params = tensor(tp)

    return GaussianScene(
        positions=tensor(new_pos),
        sh=tensor(sh),
        opacity=scene.opacity.clone(),
        scales=tensor(_np(scene.scales) * s),
        quats=tensor(new_quats),
        time_params=time_params,
    )


def _mask_scene(scene: GaussianScene, mask: np.ndarray) -> GaussianScene:
    idx = torch.from_numpy(np.flatnonzero(mask)).to(scene.device)
    return GaussianScene(*[None if leaf is None else leaf[idx] for leaf in scene])


def crop_scene(scene: GaussianScene, lower, upper) -> GaussianScene:
    """Keep the splats whose centre lies in the box ``lower ≤ p < upper``
    (half-open, so complementary crops partition a scene)."""
    lower = np.asarray(lower, np.float32)
    upper = np.asarray(upper, np.float32)
    pos = _np(scene.positions)
    mask = np.all((pos >= lower) & (pos < upper), axis=1)
    return _mask_scene(scene, mask)


def prune_scene(
    scene: GaussianScene,
    min_opacity: float = 0.0,
    max_scale: Optional[float] = None,
) -> GaussianScene:
    """Drop splats below an opacity floor and, with ``max_scale``, those
    whose largest extent is above it."""
    mask = _np(scene.opacity) >= min_opacity
    if max_scale is not None:
        mask &= _np(scene.scales).max(axis=1) <= max_scale
    return _mask_scene(scene, mask)


def merge_scenes(*scenes: GaussianScene) -> GaussianScene:
    """Concatenate scenes into one, on the first scene's device.

    SH arrays are zero-padded to the highest degree present. If any input
    is spacetime, static inputs' splats get ``(t_center=0,
    t_sigma=STATIC_T_SIGMA, v=0)`` (time-invariant) and (t, σ)-only
    inputs get zero velocity."""
    if not scenes:
        raise ValueError("merge_scenes needs at least one scene")
    sh_cols = max(s.sh.shape[1] for s in scenes)
    any_time = any(s.time_params is not None for s in scenes)
    tp_cols = max((s.time_params.shape[1] for s in scenes if s.time_params is not None),
                  default=0)

    parts = {"positions": [], "sh": [], "opacity": [], "scales": [], "quats": [],
             "time_params": []}
    for s in scenes:
        n = s.num_gaussians
        parts["positions"].append(_np(s.positions))
        sh = _np(s.sh)
        if sh.shape[1] < sh_cols:
            sh = np.pad(sh, [(0, 0), (0, sh_cols - sh.shape[1])])
        parts["sh"].append(sh)
        parts["opacity"].append(_np(s.opacity))
        parts["scales"].append(_np(s.scales))
        parts["quats"].append(_np(s.quats))
        if any_time:
            if s.time_params is None:
                tp = np.zeros((n, tp_cols), np.float32)
                tp[:, 1] = STATIC_T_SIGMA
            else:
                tp = _np(s.time_params)
                if tp.shape[1] < tp_cols:
                    tp = np.pad(tp, [(0, 0), (0, tp_cols - tp.shape[1])])
            parts["time_params"].append(tp)

    dev = scenes[0].device

    def cat(name):
        return torch.from_numpy(np.concatenate(parts[name])).to(dev)

    return GaussianScene(
        positions=cat("positions"),
        sh=cat("sh"),
        opacity=cat("opacity"),
        scales=cat("scales"),
        quats=cat("quats"),
        time_params=cat("time_params") if any_time else None,
    )
