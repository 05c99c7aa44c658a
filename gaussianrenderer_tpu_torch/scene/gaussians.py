"""Structure-of-arrays Gaussian scene on torch tensors.

Counterpart of ``gaussianrenderer_tpu.scene.gaussians``. Activations are
baked in at load (``opacity = sigmoid(raw)``, ``scale = exp(raw)``) and
``sh[:, 3*c + ch]`` is coefficient ``c`` of channel ``ch``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class GaussianScene(NamedTuple):
    """SoA 3D Gaussian scene; every field has leading dim N."""

    positions: torch.Tensor  # (N, 3) world xyz
    sh: torch.Tensor  # (N, 3*(deg+1)^2) interleaved SH coefficients
    opacity: torch.Tensor  # (N,) post-sigmoid
    scales: torch.Tensor  # (N, 3) post-exp
    quats: torch.Tensor  # (N, 4) w,x,y,z (normalized at use)
    #: (N, 2) (t_center, t_sigma) or (N, 5) adding a velocity (vx, vy, vz)
    #: for 4D spacetime scenes; None for static ones.
    time_params: Optional[torch.Tensor] = None

    @property
    def num_gaussians(self) -> int:
        return self.positions.shape[0]

    @property
    def sh_degree(self) -> int:
        n_coeff = self.sh.shape[1] // 3
        return int(round(n_coeff**0.5)) - 1

    @property
    def is_spacetime(self) -> bool:
        return self.time_params is not None

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def pad_to(self, capacity: int) -> "GaussianScene":
        """Pad to ``capacity`` splats with fully transparent ones: opacity
        0 (they never contribute), zeros elsewhere and unit quaternions."""
        n = self.num_gaussians
        if capacity < n:
            raise ValueError(f"capacity {capacity} < scene size {n}")
        if capacity == n:
            return self

        def pad(x):
            if x is None:
                return None
            return torch.cat([x, x.new_zeros((capacity - n,) + tuple(x.shape[1:]))])

        quats = pad(self.quats)
        quats[n:, 0] = 1.0
        return GaussianScene(pad(self.positions), pad(self.sh), pad(self.opacity),
                             pad(self.scales), quats, pad(self.time_params))

    def reorder(self, order: torch.Tensor) -> "GaussianScene":
        order = order.to(self.device)
        return GaussianScene(*(None if x is None else x[order] for x in self))

    def morton_sorted(self) -> "GaussianScene":
        """Reorder splats along a 3D Morton curve of their positions, so
        splats that land in the same screen tile sit close in memory."""
        codes = morton_codes(self.positions.cpu().numpy())
        return self.reorder(torch.from_numpy(np.argsort(codes, kind="stable")))


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so there are two zero bits between each."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_codes(positions: np.ndarray, bits: int = 21) -> np.ndarray:
    """64-bit Morton (Z-order) codes for world positions (host-side NumPy).

    Non-finite positions are parked at the low corner and left out of the
    bounding box, so one NaN splat cannot collapse the whole ordering.
    """
    pos = np.asarray(positions, dtype=np.float64)
    finite = np.isfinite(pos).all(axis=1)
    fin = pos[finite] if finite.any() else np.zeros((1, 3))
    lo = fin.min(axis=0)
    hi = fin.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    scale = (2**bits - 1) / extent
    pos = np.where(finite[:, None], pos, lo)
    q = np.clip((pos - lo) * scale, 0, 2**bits - 1).astype(np.uint64)
    return (
        _part1by2(q[:, 0])
        | (_part1by2(q[:, 1]) << np.uint64(1))
        | (_part1by2(q[:, 2]) << np.uint64(2))
    )
