"""COLMAP sparse-reconstruction ingestion and export (PyTorch port).

Counterpart of ``gaussianrenderer_tpu.scene.colmap``: the binary readers
and writers of a COLMAP workspace (``sparse/0/{cameras,images,
points3D}.bin`` plus ``images/``; little-endian, uint64 counts, poses as
world→camera qvec (w, x, y, z) and tvec), ``load_colmap`` (the workspace
as ``fit_scene`` views on ``device``, through ``Camera.from_pose`` in the
OpenCV convention) and ``init_from_points`` (SfM-point-seeded
``SceneParams``: DC colour from RGB, isotropic scale from the mean
distance to the 3 nearest neighbours, identity rotations).

``read_points3d_bin`` reads ``points3D.bin`` through the C++ reader
(``native/colmap_native.py``) by default, as the JAX package does, and
through the Python loop below when asked or when the C++ reader refuses
the file; both give the same arrays.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gaussianrenderer_tpu_torch._device import resolve_device

#: COLMAP camera model id → (name, number of parameters). SIMPLE_* and
#: RADIAL* models share one focal; the rest start (fx, fy, cx, cy).
CAMERA_MODELS: Dict[int, Tuple[str, int]] = {
    0: ("SIMPLE_PINHOLE", 3),  # f, cx, cy
    1: ("PINHOLE", 4),  # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),  # f, cx, cy, k
    3: ("RADIAL", 5),  # f, cx, cy, k1, k2
    4: ("OPENCV", 8),  # fx, fy, cx, cy, k1, k2, p1, p2
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


class ColmapCamera(NamedTuple):
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific (focal first)

    #: Models whose params start with a single shared focal length.
    _SINGLE_FOCAL = ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                     "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE")

    @property
    def fy(self) -> float:
        i = 0 if self.model in self._SINGLE_FOCAL else 1
        return float(self.params[i])

    @property
    def fov_y_deg(self) -> float:
        return math.degrees(2.0 * math.atan(self.height / (2.0 * self.fy)))


class ColmapImage(NamedTuple):
    qvec: np.ndarray  # (4,) w, x, y, z — world→camera rotation
    tvec: np.ndarray  # (3,) world→camera translation
    camera_id: int
    name: str


def _read(fh, fmt: str):
    size = struct.calcsize(fmt)
    data = fh.read(size)
    if len(data) != size:
        raise ValueError("truncated COLMAP binary file")
    return struct.unpack("<" + fmt, data)


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as fh:
        (num,) = _read(fh, "Q")
        for _ in range(num):
            cam_id, model_id, w, h = _read(fh, "iiQQ")
            if model_id not in CAMERA_MODELS:
                raise ValueError(f"unknown COLMAP camera model id {model_id}")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(fh, "d" * n_params), np.float64)
            cams[cam_id] = ColmapCamera(name, int(w), int(h), params)
    return cams


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path, "rb") as fh:
        (num,) = _read(fh, "Q")
        for _ in range(num):
            (image_id,) = _read(fh, "i")
            qvec = np.array(_read(fh, "dddd"), np.float64)
            tvec = np.array(_read(fh, "ddd"), np.float64)
            (camera_id,) = _read(fh, "i")
            name = b""
            while True:
                c = fh.read(1)
                if c in (b"", b"\x00"):
                    break
                name += c
            (n_pts,) = _read(fh, "Q")
            fh.seek(n_pts * 24, os.SEEK_CUR)  # (x, y, point3D_id) tracks
            images[image_id] = ColmapImage(qvec, tvec, int(camera_id), name.decode("utf-8"))
    return images


def read_points3d_bin(
    path: str, use_native: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz (N, 3) f64, rgb (N, 3) u8, error (N,) f64).

    ``use_native`` reads in one pass through the C++ reader
    (``native/colmap_native.py``); a capture's cloud reaches 10⁶ points
    and more, where this Python loop takes seconds. A file the C++ reader
    refuses goes to the loop, which reads it or raises ``ValueError``
    ("truncated COLMAP binary file"); a C++ reader that cannot be built
    raises."""
    if use_native:
        from gaussianrenderer_tpu_torch.native import colmap_native

        try:
            return colmap_native.load_points(path)
        except (ValueError, MemoryError):
            pass  # refused, or a count too large to allocate: the loop reports
    xyz: List = []
    rgb: List = []
    err: List = []
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        (num,) = _read(fh, "Q")
        for _ in range(num):
            _read(fh, "Q")  # point3D_id
            xyz.append(_read(fh, "ddd"))
            rgb.append(_read(fh, "BBB"))
            err.append(_read(fh, "d")[0])
            (track_len,) = _read(fh, "Q")
            fh.seek(track_len * 8, os.SEEK_CUR)  # (image_id, point2D_idx)
            if fh.tell() > size:  # a seek past EOF does not fail by itself
                raise ValueError("truncated COLMAP binary file")
    return (
        np.asarray(xyz, np.float64).reshape(-1, 3),
        np.asarray(rgb, np.uint8).reshape(-1, 3),
        np.asarray(err, np.float64),
    )


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion → 3×3 rotation (world→camera)."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def pose_to_c2w(qvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    """COLMAP world→camera (R, t) → (3, 4) camera→world, OpenCV axes."""
    r = qvec2rotmat(qvec)
    return np.concatenate(
        [r.T, (-r.T @ np.asarray(tvec, np.float64))[:, None]], axis=1
    ).astype(np.float32)


def find_sparse_dir(dataset_dir: str) -> str:
    """The reconstruction's directory: ``<dir>/sparse/0``, ``<dir>/sparse``
    or ``<dir>`` itself, whichever holds ``cameras.bin`` first."""
    for cand in (
        os.path.join(dataset_dir, "sparse", "0"),
        os.path.join(dataset_dir, "sparse"),
        dataset_dir,
    ):
        if os.path.isfile(os.path.join(cand, "cameras.bin")):
            return cand
    raise FileNotFoundError(f"no COLMAP reconstruction (cameras.bin) under {dataset_dir}")


def is_colmap_dir(dataset_dir: str) -> bool:
    try:
        find_sparse_dir(dataset_dir)
        return True
    except FileNotFoundError:
        return False


def load_colmap(
    dataset_dir: str,
    cfg,
    k_sigma: float = 3.0,
    image_dir: Optional[str] = None,
    near: float = 0.1,
    far: float = 100.0,
    limit: Optional[int] = None,
    stride: int = 1,
    device="cuda",
):
    """A COLMAP workspace as ``fit_scene`` views [(CameraParams, target)]
    on ``device``.

    ``stride`` keeps every Nth registered image in image-id order, chosen
    before any image is opened. Images resize to ``cfg.height ×
    cfg.width`` with PIL's LANCZOS filter (the vertical field of view
    does not depend on the resolution; an aspect more than 2% off
    raises). Distortion coefficients are ignored (pinhole approximation:
    undistort first). Targets are planar (3, H, W) float32, bottom row
    first, as :func:`train.render_for_training` renders."""
    from PIL import Image

    from gaussianrenderer_tpu_torch.scene.camera import Camera

    dev = resolve_device(device)
    sparse = find_sparse_dir(dataset_dir)
    cams = read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    images = read_images_bin(os.path.join(sparse, "images.bin"))
    img_root = image_dir or os.path.join(dataset_dir, "images")
    if not os.path.isdir(img_root):
        img_root = dataset_dir

    views = []
    for _, im in sorted(images.items())[:: max(stride, 1)]:
        cc = cams[im.camera_id]
        aspect = cc.width / cc.height
        if abs(aspect - cfg.width / cfg.height) > 0.02 * aspect:
            raise ValueError(
                f"{im.name}: capture aspect {aspect:.3f} != config "
                f"{cfg.width / cfg.height:.3f} — crop or change cfg"
            )
        cam = Camera.from_pose(
            pose_to_c2w(im.qvec, im.tvec),
            fov_y_deg=cc.fov_y_deg,
            aspect=cfg.width / cfg.height,
            near=near,
            far=far,
            convention="opencv",
        )
        img = Image.open(os.path.join(img_root, im.name)).convert("RGB")
        if img.size != (cfg.width, cfg.height):
            img = img.resize((cfg.width, cfg.height), Image.LANCZOS)
        arr = np.asarray(img, np.float32) / 255.0
        # (H, W, 3) top-down image → planar (3, H, W) bottom-up target.
        target = torch.from_numpy(np.ascontiguousarray(arr[::-1].transpose(2, 0, 1))).to(dev)
        views.append((cam.params(k_sigma, device=dev), target))
        if limit and len(views) >= limit:
            break
    if not views:
        raise ValueError(f"no registered images in {sparse}")
    return views


def load_colmap_points(dataset_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """(xyz (N, 3) f32, rgb (N, 3) f32 in [0, 1]) from points3D.bin."""
    sparse = find_sparse_dir(dataset_dir)
    xyz, rgb, _ = read_points3d_bin(os.path.join(sparse, "points3D.bin"))
    return xyz.astype(np.float32), rgb.astype(np.float32) / 255.0


_SH_C0 = 0.28209479177387814  # Y_0^0, the DC band


def init_from_points(
    xyz: np.ndarray,
    rgb: np.ndarray,
    n: Optional[int] = None,
    sh_degree: int = 2,
    seed: int = 0,
    knn: int = 3,
    device="cuda",
):
    """SfM-point-seeded ``train.SceneParams`` on ``device`` (the upstream
    3DGS initialization).

    Positions are the points, subsampled without replacement or
    upsampled with a jitter of the local spacing to ``n``; the DC term
    inverts the render's ``0.5 + C0·dc`` so each splat starts at its
    point's colour; opacity starts at sigmoid⁻¹(0.1); each scale is
    ln(mean distance to the ``knn`` nearest neighbours) on all three axes
    (scipy cKDTree), at least 1e-4; rotations are identity quaternions.
    The draws come from ``np.random.default_rng(seed)`` in the JAX
    package's order."""
    from gaussianrenderer_tpu_torch.train import SceneParams

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    rgb = np.asarray(rgb, np.float32).reshape(-1, 3)
    m = xyz.shape[0]
    if m == 0:
        raise ValueError("empty point cloud")
    n = n or m
    if n <= m:
        idx = rng.choice(m, n, replace=False)
        pos, col = xyz[idx], rgb[idx]
    else:
        # Upsample: redraw points with a small local jitter so the clones
        # start apart.
        idx = rng.choice(m, n - m, replace=True)
        jitter = rng.normal(0.0, 1.0, (n - m, 3)).astype(np.float32)
        pos = np.concatenate([xyz, xyz[idx]], axis=0)
        col = np.concatenate([rgb, rgb[idx]], axis=0)
        scale_hint = (_nn_mean_dist(xyz, min(knn, m - 1)) if m > 1
                      else np.ones(m, np.float32))
        pos[m:] += jitter * scale_hint[idx][:, None]

    d = _nn_mean_dist(pos, knn) if n > 1 else np.full(1, 0.1, np.float32)
    d = np.clip(d, 1e-4, None)

    sh = np.zeros((n, 3 * (sh_degree + 1) ** 2), np.float32)
    sh[:, :3] = (col - 0.5) / _SH_C0  # invert clamp(0.5 + C0·dc)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    return SceneParams(
        positions=t(pos),
        sh=t(sh),
        raw_opacity=torch.full((n,), float(np.log(0.1 / 0.9)), dtype=torch.float32,
                               device=dev),
        raw_scales=t(np.log(d)[:, None].repeat(3, axis=1)),
        quats=t(quats),
    )


def _nn_mean_dist(pos: np.ndarray, k: int) -> np.ndarray:
    """Mean distance to the k nearest neighbours, per point (f32)."""
    from scipy.spatial import cKDTree

    k = max(1, min(k, pos.shape[0] - 1))
    dist, _ = cKDTree(pos).query(pos, k=k + 1)  # column 0 is the point itself
    return dist[:, 1:].mean(axis=1).astype(np.float32)


# ---------------------------------------------------------------- writers
# A capture workspace from rendered views: the inverse of the readers.

_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


def rotmat2qvec(r: np.ndarray) -> np.ndarray:
    """3×3 rotation → COLMAP (w, x, y, z) quaternion (branch-robust)."""
    r = np.asarray(r, np.float64)
    t = np.trace(r)
    if t > 0:
        w = math.sqrt(1.0 + t) / 2.0
        q = np.array(
            [w, (r[2, 1] - r[1, 2]) / (4 * w),
             (r[0, 2] - r[2, 0]) / (4 * w),
             (r[1, 0] - r[0, 1]) / (4 * w)]
        )
    else:
        i = int(np.argmax([r[0, 0], r[1, 1], r[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 0.0)) * 2.0
        q = np.zeros(4)
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = s / 4.0
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
    return q / np.linalg.norm(q)


def camera_w2c(cam) -> Tuple[np.ndarray, np.ndarray]:
    """A ``Camera`` → COLMAP (qvec, tvec), world→camera in OpenCV axes.

    The camera→world rotation's columns in OpenCV axes are (right, down,
    forward) = (r_axis, −u_axis, −f_axis): ``f_axis`` is camera-space +z,
    which points away from the view direction. COLMAP stores the
    transpose with t = −R·position."""
    r = np.stack([cam.r_axis, -cam.u_axis, -cam.f_axis], axis=1).astype(np.float64).T
    t = -r @ np.asarray(cam.position, np.float64)
    return rotmat2qvec(r), t


def write_cameras_bin(path: str, cams: Dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(cams)))
        for cam_id, cc in sorted(cams.items()):
            mid = _MODEL_IDS[cc.model]
            n_params = CAMERA_MODELS[mid][1]
            params = np.asarray(cc.params, np.float64)
            if params.shape != (n_params,):
                raise ValueError(f"{cc.model} takes {n_params} params, got {params.shape}")
            fh.write(struct.pack("<iiQQ", cam_id, mid, cc.width, cc.height))
            fh.write(struct.pack("<" + "d" * n_params, *params))


def write_images_bin(path: str, images: Dict[int, ColmapImage]) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(images)))
        for image_id, im in sorted(images.items()):
            fh.write(struct.pack("<i", image_id))
            fh.write(struct.pack("<dddd", *np.asarray(im.qvec, np.float64)))
            fh.write(struct.pack("<ddd", *np.asarray(im.tvec, np.float64)))
            fh.write(struct.pack("<i", im.camera_id))
            fh.write(im.name.encode("utf-8") + b"\x00")
            fh.write(struct.pack("<Q", 0))  # no 2D track points


def write_points3d_bin(
    path: str,
    xyz: np.ndarray,
    rgb: np.ndarray,
    error: Optional[np.ndarray] = None,
) -> None:
    """points3D.bin with empty tracks; ``rgb`` is u8 or floats in [0, 1].
    One structured array and ``tobytes``, not a loop of ``struct.pack``."""
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(np.round(np.asarray(rgb, np.float64) * 255), 0, 255)
        rgb = rgb.astype(np.uint8)
    rgb = rgb.reshape(-1, 3)
    err = np.zeros(len(xyz)) if error is None else np.asarray(error, np.float64)
    rec = np.zeros(len(xyz), dtype=np.dtype([
        ("id", "<u8"),
        ("xyz", "<f8", 3),
        ("rgb", "u1", 3),
        ("err", "<f8"),
        ("track_len", "<u8"),
    ]))
    rec["id"] = np.arange(len(xyz), dtype=np.uint64)
    rec["xyz"] = xyz
    rec["rgb"] = rgb
    rec["err"] = err
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(xyz)))
        fh.write(rec.tobytes())


def save_colmap_workspace(
    dataset_dir: str,
    cams,
    frames,
    *,
    points_xyz: Optional[np.ndarray] = None,
    points_rgb: Optional[np.ndarray] = None,
    names: Optional[List[str]] = None,
) -> str:
    """Cameras and rendered frames → a COLMAP workspace.

    ``cams`` are :class:`Camera` objects (matrices updated); ``frames``
    the matching top-down (H, W, 3) uint8 images (or floats in [0, 1]),
    e.g. ``render.framebuffer_to_image`` output. All views share one
    PINHOLE camera from the first camera's FOV and the frame shape. The
    layout is ``sparse/0/{cameras,images,points3D}.bin`` and
    ``images/*.png`` (points3D.bin only with ``points_xyz``). Returns
    ``dataset_dir``."""
    from PIL import Image

    if len(cams) != len(frames):
        raise ValueError("cams and frames length mismatch")
    h, w = np.asarray(frames[0]).shape[:2]
    fy = h / (2.0 * math.tan(math.radians(cams[0].fov_y) * 0.5))
    fx = fy  # square pixels: the aspect is carried by w/h
    sparse = os.path.join(dataset_dir, "sparse", "0")
    img_dir = os.path.join(dataset_dir, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)

    write_cameras_bin(
        os.path.join(sparse, "cameras.bin"),
        {1: ColmapCamera("PINHOLE", w, h, np.array([fx, fy, w / 2.0, h / 2.0]))},
    )
    images: Dict[int, ColmapImage] = {}
    for i, (cam, frame) in enumerate(zip(cams, frames)):
        name = names[i] if names else f"frame_{i:04d}.png"
        qvec, tvec = camera_w2c(cam)
        images[i + 1] = ColmapImage(qvec, tvec, 1, name)
        arr = np.asarray(frame)
        if arr.dtype != np.uint8:
            arr = np.clip(np.round(arr * 255), 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, name))
    write_images_bin(os.path.join(sparse, "images.bin"), images)

    if points_xyz is not None:
        write_points3d_bin(
            os.path.join(sparse, "points3D.bin"),
            points_xyz,
            points_rgb if points_rgb is not None
            else np.full((len(points_xyz), 3), 128, np.uint8),
        )
    return dataset_dir
