"""Blender / NeRF-synthetic ``transforms*.json`` dataset ingestion
(PyTorch port).

Counterpart of ``gaussianrenderer_tpu.scene.blender``. A dataset
directory holds ``transforms_train.json`` / ``_test`` / ``_val``
(NeRF-synthetic, D-NeRF) or one ``transforms.json`` (instant-ngp). Each
frame has a camera→world ``transform_matrix`` in OpenGL axes and a
``file_path`` (the extension may be left out). Intrinsics come from
``fl_y`` (pixels), ``camera_angle_y`` or ``camera_angle_x`` (radians), a
frame's own keys before the file's. A D-NeRF ``time`` makes the view a
timed triple. RGBA images are composited over ``background``; train with
``RenderConfig(background=...)`` set to the same colour.

The images go through the same PIL calls and LANCZOS filter as the
reference's, so resized targets are equal arrays.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from gaussianrenderer_tpu_torch._device import resolve_device

__all__ = [
    "is_blender_dir",
    "find_transforms",
    "blender_image_shape",
    "load_blender",
]

_SPLIT_ORDER = ("train", "test", "val")


def find_transforms(dataset_dir: str, split: Optional[str] = None) -> str:
    """Path of the dataset's transforms file: ``transforms_{split}.json``
    when ``split`` is given, else the train split, then the splitless
    ``transforms.json``, then any split present."""
    if split is not None:
        cand = os.path.join(dataset_dir, f"transforms_{split}.json")
        if os.path.isfile(cand):
            return cand
        raise FileNotFoundError(f"{dataset_dir}: no transforms_{split}.json")
    names = [f"transforms_{s}.json" for s in _SPLIT_ORDER]
    names.insert(1, "transforms.json")  # after train, before test/val
    for name in names:
        cand = os.path.join(dataset_dir, name)
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(f"{dataset_dir}: no transforms*.json")


def is_blender_dir(dataset_dir: str) -> bool:
    try:
        find_transforms(dataset_dir)
        return True
    except FileNotFoundError:
        return False


def _resolve_image(dataset_dir: str, file_path: str) -> str:
    """NeRF-synthetic ``file_path`` entries leave out the extension."""
    path = os.path.normpath(os.path.join(dataset_dir, file_path))
    if os.path.isfile(path):
        return path
    for ext in (".png", ".jpg", ".jpeg"):
        if os.path.isfile(path + ext):
            return path + ext
    raise FileNotFoundError(f"{file_path}: no image at {path}[.png/.jpg]")


def blender_image_shape(dataset_dir: str, split: Optional[str] = None) -> Tuple[int, int]:
    """(height, width) without loading the dataset: the meta's ``h``/``w``
    where it has them, else the first frame's image."""
    with open(find_transforms(dataset_dir, split)) as fh:
        meta = json.load(fh)
    if "h" in meta and "w" in meta:
        return int(meta["h"]), int(meta["w"])
    if not meta.get("frames"):
        raise ValueError(f"{dataset_dir}: transforms file has no frames")
    from PIL import Image

    path = _resolve_image(dataset_dir, meta["frames"][0]["file_path"])
    with Image.open(path) as im:
        return int(im.height), int(im.width)


def _fov_y_deg(meta: dict, frame: dict, height: int, width: int) -> float:
    """Vertical FOV in degrees from whichever intrinsics the file carries,
    a frame's keys before the file's. ``fl_y`` is in pixels of the
    dataset's own resolution (``height``); ``camera_angle_x`` converts
    through the aspect."""
    for src in (frame, meta):
        if "fl_y" in src:
            return math.degrees(2.0 * math.atan(height / (2.0 * src["fl_y"])))
        if "camera_angle_y" in src:
            return math.degrees(float(src["camera_angle_y"]))
        if "camera_angle_x" in src:
            half_x = float(src["camera_angle_x"]) / 2.0
            return math.degrees(2.0 * math.atan(math.tan(half_x) * height / width))
    raise ValueError(
        "transforms frame has no intrinsics (camera_angle_x / camera_angle_y / fl_y)"
    )


def load_blender(
    dataset_dir: str,
    cfg,
    k_sigma: float = 3.0,
    stride: int = 1,
    split: Optional[str] = None,
    background: Optional[Tuple[float, float, float]] = None,
    near: float = 0.01,
    far: float = 100.0,
    device="cuda",
):
    """A transforms*.json dataset as :func:`train.fit_scene` views on
    ``device``: (cam_params, target) pairs, or (cam_params, target, time)
    triples for frames with a D-NeRF ``time``.

    ``stride`` keeps every Nth frame. Images of another size resize to
    ``cfg.height × cfg.width`` (LANCZOS, before the alpha composite) when
    the aspect matches (more than 2% off raises). RGBA images composite
    over ``background`` (default black). Targets are planar (3, H, W)
    float32, bottom row first. ``near``/``far`` default to the upstream
    Blender loader's 0.01/100, a frame's own keys first."""
    from PIL import Image

    from gaussianrenderer_tpu_torch.scene.camera import Camera

    dev = resolve_device(device)
    with open(find_transforms(dataset_dir, split)) as fh:
        meta = json.load(fh)
    # The dataset's own resolution, for the focal → FOV conversion: fl_y
    # is in pixels of the images, so cfg (smaller under a downscale) is no
    # stand-in for it.
    if "h" in meta and "w" in meta:
        ds_h, ds_w = int(meta["h"]), int(meta["w"])
    elif meta.get("frames"):
        p0 = _resolve_image(dataset_dir, meta["frames"][0]["file_path"])
        with Image.open(p0) as im0:
            ds_h, ds_w = int(im0.height), int(im0.width)
    else:
        ds_h, ds_w = cfg.height, cfg.width
    bg = np.asarray(background if background is not None else (0.0, 0.0, 0.0), np.float32)

    views = []
    for frame in meta.get("frames", [])[:: max(stride, 1)]:
        cam = Camera.from_pose(
            np.asarray(frame["transform_matrix"], np.float32),
            fov_y_deg=_fov_y_deg(meta, frame, ds_h, ds_w),
            aspect=cfg.width / cfg.height,
            near=frame.get("near", near),
            far=frame.get("far", far),
            convention="opengl",
        )
        path = _resolve_image(dataset_dir, frame["file_path"])
        pil = Image.open(path)
        aspect = pil.width / pil.height
        if abs(aspect - cfg.width / cfg.height) > 0.02 * aspect:
            raise ValueError(
                f"{frame['file_path']}: capture aspect {aspect:.3f} != "
                f"config {cfg.width / cfg.height:.3f} — crop or change cfg"
            )
        if pil.size != (cfg.width, cfg.height):
            pil = pil.resize((cfg.width, cfg.height), Image.LANCZOS)
        img = np.asarray(pil)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if img.ndim != 3:
            raise ValueError(
                f"{frame['file_path']}: expected an RGB(A) image, got shape {img.shape}"
            )
        if img.shape[2] >= 4:
            alpha = img[:, :, 3:4]
            img = img[:, :, :3] * alpha + bg * (1.0 - alpha)
        # (H, W, 3) top-down image → planar (3, H, W) bottom-up target.
        target = torch.from_numpy(np.ascontiguousarray(
            img[::-1, :, :3].transpose(2, 0, 1), dtype=np.float32)).to(dev)
        view = (cam.params(k_sigma, device=dev), target)
        views.append(view + (float(frame["time"]),) if "time" in frame else view)
    return views
