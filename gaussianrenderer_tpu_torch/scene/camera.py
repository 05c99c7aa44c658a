"""Look-at camera with the reference's matrix and plane conventions.

Counterpart of ``gaussianrenderer_tpu.scene.camera``: the host-side
``Camera`` keeps its NumPy math unchanged (row-major view with rows
(r, u, −f), OpenGL perspective, frustum planes, orbit and zoom), and
``CameraParams`` carries the frozen per-frame state as torch tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gaussianrenderer_tpu_torch._device import resolve_device


class CameraParams(NamedTuple):
    """Per-frame camera state consumed by the render pipeline."""

    view: torch.Tensor  # (4,4) world→camera rigid transform, row-major
    proj: torch.Tensor  # (4,4) OpenGL perspective
    r_cam: torch.Tensor  # (3,3) world→camera rotation (rows r,u,-f)
    position: torch.Tensor  # (3,) world-space camera position
    fov_y: torch.Tensor  # () degrees
    aspect: torch.Tensor  # ()
    near: torch.Tensor  # ()
    far: torch.Tensor  # ()
    k_sigma: torch.Tensor  # () splat radius multiplier

    @property
    def full_proj(self) -> torch.Tensor:
        return self.proj @ self.view


def _normalize(v: np.ndarray) -> np.ndarray:
    n = float(np.sqrt(np.dot(v, v)))
    # Zero-guard matching reference normalize (math.cpp:7-19).
    if n > 1e-8:
        return v / n
    return np.zeros_like(v)


def perspective_matrix(fov_y_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """OpenGL perspective, row-major (reference ``math.cpp:91-97``)."""
    f = 1.0 / math.tan(math.radians(fov_y_deg) * 0.5)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2.0 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m


class Camera:
    """Mutable host-side camera with the reference's public surface."""

    def __init__(self) -> None:
        # Defaults per reference ``camera.cpp:8-13``.
        self.fov_y: float = 45.0
        self.aspect: float = 1.0
        self.near: float = 0.1
        self.far: float = 100.0
        self.position = np.array([0.0, 0.0, 5.0], dtype=np.float32)
        self.look_at = np.array([0.0, 0.0, 0.0], dtype=np.float32)
        self.w_up = np.array([0.0, 1.0, 0.0], dtype=np.float32)

        self.f_axis = np.zeros(3, dtype=np.float32)
        self.r_axis = np.zeros(3, dtype=np.float32)
        self.u_axis = np.zeros(3, dtype=np.float32)
        self.view = np.eye(4, dtype=np.float32)
        self.proj = np.eye(4, dtype=np.float32)
        self.full_proj = np.eye(4, dtype=np.float32)
        self.r_cam = np.eye(3, dtype=np.float32)
        self.plane_normals = np.zeros((6, 4), dtype=np.float32)
        self.update_camera_matrices()
        self.update_frustum_planes()

    # ----------------------------------------------------------- reference API
    def set_position(self, pos) -> None:
        self.position = np.asarray(pos, dtype=np.float32).copy()

    def set_look_at(self, target) -> None:
        self.look_at = np.asarray(target, dtype=np.float32).copy()

    def set_world_up(self, up) -> None:
        self.w_up = np.asarray(up, dtype=np.float32).copy()

    def set_fov_y(self, fov_deg: float) -> None:
        self.fov_y = float(fov_deg)

    def set_aspect_ratio(self, aspect: float) -> None:
        self.aspect = float(aspect)

    def set_clipping_planes(self, near: float, far: float) -> None:
        self.near = float(near)
        self.far = float(far)

    def update_camera_matrices(self) -> None:
        """Rebuild basis, V, P, M and r_cam (reference ``camera.cpp:36-57``)."""
        f = _normalize(self.look_at - self.position)
        r = _normalize(np.cross(f, self.w_up))
        u = np.cross(r, f)
        f = -f  # camera looks down −z in camera space
        self.f_axis, self.r_axis, self.u_axis = f, r, u

        self.r_cam = np.stack([r, u, f]).astype(np.float32)

        v = np.eye(4, dtype=np.float32)
        v[0, :3], v[0, 3] = r, -float(np.dot(r, self.position))
        v[1, :3], v[1, 3] = u, -float(np.dot(u, self.position))
        v[2, :3], v[2, 3] = f, -float(np.dot(f, self.position))
        self.view = v
        self.proj = perspective_matrix(self.fov_y, self.aspect, self.near, self.far)
        self.full_proj = (self.proj @ self.view).astype(np.float32)

    def update_frustum_planes(self) -> None:
        """Six (nx,ny,nz,offset) planes (reference ``camera.cpp:59-121``).

        Near/far planes pass through the camera position offset by the clip
        distances; the four side planes are camera-relative with offset 0.
        """
        f, r, u, pos = self.f_axis, self.r_axis, self.u_axis, self.position
        planes = np.zeros((6, 4), dtype=np.float32)
        planes[0, :3] = f
        planes[0, 3] = float(np.dot(f, pos)) - self.near
        planes[1, :3] = -f
        planes[1, 3] = -(float(np.dot(f, pos)) - self.far)
        t_y = math.tan(math.radians(self.fov_y) * 0.5)
        t_x = t_y * self.aspect
        planes[2, :3] = _normalize(f * t_x - r)  # right
        planes[3, :3] = _normalize(f * t_x + r)  # left
        planes[4, :3] = _normalize(f * t_y - u)  # top
        planes[5, :3] = _normalize(f * t_y + u)  # bottom
        self.plane_normals = planes

    def zoom(self, delta: float) -> None:
        """Move along the stored (negated) forward axis (``camera.cpp:123-128``)."""
        self.position = self.position + self.f_axis * float(delta)
        self.update_camera_matrices()

    def orbit(self, azimuth_deg: float, elevation_deg: float) -> None:
        """Spherical orbit about look_at (``camera.cpp:130-158``)."""
        azimuth = math.radians(azimuth_deg)
        elevation = math.radians(elevation_deg)
        radius_vec = self.position - self.look_at
        radius = float(np.linalg.norm(radius_vec))
        theta = math.atan2(float(radius_vec[2]), float(radius_vec[0]))
        phi = math.acos(float(radius_vec[1]) / radius)
        theta += azimuth
        phi += elevation
        eps = 0.01
        phi = min(max(phi, eps), math.pi - eps)
        radius_vec = np.array(
            [
                radius * math.sin(phi) * math.cos(theta),
                radius * math.cos(phi),
                radius * math.sin(phi) * math.sin(theta),
            ],
            dtype=np.float32,
        )
        self.position = self.look_at + radius_vec
        self.update_camera_matrices()

    @classmethod
    def from_pose(
        cls,
        c2w,
        *,
        fov_y_deg: float = None,
        fy: float = None,
        height: int = None,
        aspect: float = 1.0,
        near: float = 0.1,
        far: float = 100.0,
        convention: str = "opencv",
    ) -> "Camera":
        """Camera from an external capture pose (real-dataset adapter).

        ``c2w`` is a (3,4)/(4,4) camera-to-world matrix in the given
        convention — ``"opencv"``/COLMAP (x right, y down, z forward; the
        convention of 3DGS training datasets) or ``"opengl"`` (y up, −z
        forward). The vertical field of view comes from ``fov_y_deg`` or
        the pinhole pair ``(fy, height)`` (fov = 2·atan(H/(2·fy))). The
        rotation is reproduced exactly through the look-at construction:
        forward and up from the pose are orthonormal, so
        :meth:`update_camera_matrices` rebuilds the same basis — and every
        session control (orbit/zoom/frustum planes) keeps working on top.
        The reference has no pose import (its camera is interactive-only,
        ``camera.cpp``); this is the trainer-side extension for fitting
        captured scenes."""
        m = np.asarray(c2w, dtype=np.float32)
        if m.shape == (4, 4):
            m = m[:3]
        if m.shape != (3, 4):
            raise ValueError(f"c2w must be (3,4) or (4,4), got {m.shape}")
        if convention == "opencv":
            forward, up = m[:, 2], -m[:, 1]
        elif convention == "opengl":
            forward, up = -m[:, 2], m[:, 1]
        else:
            raise ValueError(f"unknown convention {convention!r}")
        if fov_y_deg is None:
            if fy is None or height is None:
                raise ValueError("need fov_y_deg or (fy, height)")
            fov_y_deg = math.degrees(2.0 * math.atan(height / (2.0 * fy)))
        cam = cls()
        cam.set_position(m[:, 3])
        cam.set_look_at(m[:, 3] + forward)
        cam.set_world_up(up)
        cam.set_fov_y(fov_y_deg)
        cam.set_aspect_ratio(aspect)
        cam.set_clipping_planes(near, far)
        cam.update_camera_matrices()
        cam.update_frustum_planes()
        return cam

    def transform_point_to_camera_space(self, point) -> np.ndarray:
        """M·p with w-divide (reference ``camera.cpp:160-170``)."""
        p = np.asarray(point, dtype=np.float32)
        if p.shape == (3,):
            p = np.concatenate([p, np.ones(1, dtype=np.float32)])
        out = self.full_proj @ p
        out[:3] = out[:3] / out[3]
        return out

    # ------------------------------------------------------------------ export
    def params(self, k_sigma: float = 3.0, device="cuda") -> CameraParams:
        """Freeze the current state into float32 tensors on ``device``."""
        dev = resolve_device(device)

        def t(x):
            return torch.as_tensor(
                np.asarray(x, dtype=np.float32), device=dev
            )

        return CameraParams(
            view=t(self.view),
            proj=t(self.proj),
            r_cam=t(self.r_cam),
            position=t(self.position),
            fov_y=t(self.fov_y),
            aspect=t(self.aspect),
            near=t(self.near),
            far=t(self.far),
            k_sigma=t(k_sigma),
        )
