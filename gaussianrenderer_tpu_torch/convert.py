"""Carry scene, camera and training state across from NumPy arrays.

The JAX package's containers hold the same fields under the same names.
Each function here takes any object with those attributes (a JAX-side
``GaussianScene`` or ``CameraParams`` after ``np.asarray`` on its
leaves, or the port's own containers) and returns
the port's container on ``device``. NumPy is the only interface: nothing
here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussianrenderer_tpu_torch._device import resolve_device
from gaussianrenderer_tpu_torch.scene.camera import CameraParams
from gaussianrenderer_tpu_torch.scene.gaussians import GaussianScene
from gaussianrenderer_tpu_torch.train import AdamState, DensifyState, SceneParams


def _tensor(x, dev, dtype=None):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    # np.array (not ascontiguousarray) keeps 0-d scalars 0-d.
    return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)


def to_torch_scene(scene, device="cuda") -> GaussianScene:
    """A scene's (positions, sh, opacity, scales, quats, time_params)
    arrays → the port's ``GaussianScene`` (float32) on ``device``."""
    dev = resolve_device(device)
    return GaussianScene(
        *(_tensor(getattr(scene, f), dev, np.float32) for f in GaussianScene._fields)
    )


def to_torch_camera(cam, device="cuda") -> CameraParams:
    """Camera parameters (view, proj, r_cam, position, fov_y, aspect,
    near, far, k_sigma) → the port's ``CameraParams`` (float32)."""
    dev = resolve_device(device)
    return CameraParams(
        *(_tensor(getattr(cam, f), dev, np.float32) for f in CameraParams._fields)
    )


def to_torch_params(params, device="cuda"):
    """Trainable parameters (positions, sh, raw_opacity, raw_scales,
    quats, optional time_params; the JAX package's ``SceneParams`` after
    ``np.asarray`` on its leaves) → the port's ``train.SceneParams``
    (float32) on ``device``."""
    dev = resolve_device(device)
    return SceneParams(
        *(_tensor(getattr(params, f), dev, np.float32) for f in SceneParams._fields)
    )


def to_torch_densify_state(state, device="cuda") -> DensifyState:
    """Densification accumulators (grad_accum, denom, steps; the JAX
    package's ``DensifyState`` after ``np.asarray`` on its leaves) → the
    port's ``train.DensifyState`` on ``device``."""
    dev = resolve_device(device)
    return DensifyState(_tensor(state.grad_accum, dev, np.float32),
                        _tensor(state.denom, dev, np.float32),
                        _tensor(state.steps, dev, np.int32))


def to_torch_adam_state(count, mu, nu, device="cuda") -> AdamState:
    """Adam's step count and moments (an optax ``adam`` state's ``count``,
    ``mu`` and ``nu``, each moment a SceneParams-like object of NumPy
    arrays) → the port's ``train.AdamState`` on ``device``."""
    dev = resolve_device(device)
    return AdamState(_tensor(count, dev, np.int32), to_torch_params(mu, dev),
                     to_torch_params(nu, dev))
