"""Render and viewer configuration (PyTorch port).

Copies of ``gaussianrenderer_tpu.config.RenderConfig`` and ``UiSettings``
with the same fields, defaults and derived properties, so one
configuration reads the same in both packages. Fields that size the JAX package's static buffers (the
instance capacity and tier ladder) are kept so a config can be carried
across unchanged; the port emits by count → scan and does not read them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of the render pipeline.

    A ``num_tile_x × num_tile_y`` grid over a ``width × height``
    framebuffer with ceil-div pixel strides; 0 tiles means auto (32×32).
    """

    height: int = 800
    width: int = 800
    num_tile_x: int = 0
    num_tile_y: int = 0
    #: Spherical-harmonics degree for view-dependent color (0-3).
    sh_degree: int = 2
    #: k-sigma radius of the screen-space AABB (camera params carry the
    #: per-frame value; this is only the default).
    k_sigma: float = 3.0
    #: Size the JAX package's static instance buffer; the port's emission
    #: has no static size, so these are not read.
    instance_multiplier: float = 8.0
    min_instance_capacity: int = 4096
    #: Instance lanes per chunk of the f32 tile-sort compositors (xla,
    #: diff and the training kernels).
    chunk_size: int = 128
    #: Instance lanes per compositor chunk: the granularity of the tile
    #: walk and of its early exit.
    packed_chunk: int = 256
    #: "packed" (the CUDA packed-record compositor; on a grid it cannot
    #: describe, the xla one), "xla" (f32 tile sort, early exit) or "diff"
    #: (differentiable: the training kernels or the scan compositor).
    compositor: str = "packed"
    #: Composite over a background color (r, g, b in [0, 1]) as
    #: rgb + T_final·bg; None keeps the implicit black.
    background: "Optional[Tuple[float, float, float]]" = None
    #: Append the accumulated-alpha row (1 − final transmittance).
    output_alpha: bool = False
    #: Append the expected-depth row Σ wᵢ·dᵢ. Channel order: rgb,
    #: [alpha], [depth].
    output_depth: bool = False
    #: The scan compositor ("diff" without the kernels) walks at most this
    #: many chunks per tile; the training kernels do not truncate.
    diff_max_chunks: int = 32
    #: "diff" takes the training kernels (ops/tile_train.py) when the tile
    #: is a multiple of 128 pixels, as the JAX package's kernel does, and
    #: no depth row is asked for; False (or otherwise) takes the scan
    #: compositor.
    diff_kernel: bool = True
    #: Kept for the JAX package's signature and not read there or here:
    #: the sort key spends the bits the tile id leaves on depth.
    depth_scale: float = 1.0e6
    #: Round splat centers to integer pixels.
    quantize_centers: bool = True
    #: EWA low-pass dilation added to the 2D covariance diagonal (px²).
    ewa_dilation: float = 0.0
    #: Scale opacity by sqrt(det(Σ)/det(Σ + dilation·I)) (upstream 3DGS
    #: antialiasing mode); only meaningful with ``ewa_dilation > 0``.
    ewa_compensate: bool = False
    #: The JAX package's instance tier ladder; not read (no static lanes).
    tier_boost: int = 0
    tiers: Optional[tuple] = None
    sat_cull: bool = False
    sat_margin: float = 0.25
    sat_dilate: int = 1

    # ---------------------------------------------------------------- derived
    @property
    def tile_w(self) -> int:
        if self.num_tile_x > 0:
            return _cdiv(self.width, self.num_tile_x)
        return 32

    @property
    def tile_h(self) -> int:
        if self.num_tile_y > 0:
            return _cdiv(self.height, self.num_tile_y)
        return 32

    @property
    def packed_compatible(self) -> bool:
        """Tile shapes the packed records can describe: a lane-aligned
        pixel count, u8 tile-local AABBs, and centers inside the ±4096 px
        13.3 fixed-point window."""
        return (
            (self.tile_w * self.tile_h) % 128 == 0
            and self.tile_w <= 255
            and self.tile_h <= 255
            and self.tiles_x <= 1024
            and self.tiles_y <= 1024
            and self.width <= 4096
            and self.height <= 4096
        )

    @property
    def tiles_x(self) -> int:
        if self.num_tile_x > 0:
            return self.num_tile_x
        return max(1, _cdiv(self.width, self.tile_w))

    @property
    def tiles_y(self) -> int:
        if self.num_tile_y > 0:
            return self.num_tile_y
        return max(1, _cdiv(self.height, self.tile_h))

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    def instance_capacity(self, num_gaussians: int) -> int:
        cap = int(math.ceil(num_gaussians * self.instance_multiplier))
        cap = max(cap, self.min_instance_capacity)
        return _cdiv(cap, self.chunk_size) * self.chunk_size

    @staticmethod
    def auto_packed_chunk(sort_lanes: int) -> int:
        return 128 if sort_lanes < 1_500_000 else 256

    def with_resolution(self, height: int, width: int) -> "RenderConfig":
        return dataclasses.replace(self, height=height, width=width)


@dataclasses.dataclass
class UiSettings:
    """Runtime-adjustable viewer settings (the reference ImGui
    ``UiSettings``, ``canvas.hpp:7-19``): flip-Y display, k-sigma splat
    radius, fovY, and a tile grid with an X/Y lock."""

    flip_y: bool = True
    k_sigma: float = 3.0
    fov_y: float = 45.0  # matches the Camera default
    num_tile_x: int = 0
    num_tile_y: int = 0
    lock_tiles: bool = True
    #: 4D scenes: the slice time. None renders static (ignored when the
    #: scene has no time_params).
    time_value: Optional[float] = None
    #: Display mode: "rgb" or "depth" (the alpha-normalized expected-depth
    #: row, min-max scaled to gray).
    view_mode: str = "rgb"

    def clamp(self) -> None:
        self.k_sigma = min(max(self.k_sigma, 0.1), 8.0)
        self.fov_y = min(max(self.fov_y, 10.0), 160.0)
        if self.view_mode not in ("rgb", "depth"):
            self.view_mode = "rgb"
        if self.lock_tiles and self.num_tile_x > 0:
            self.num_tile_y = self.num_tile_x


def parse_color(spec: "Optional[str]") -> "Optional[Tuple[float, float, float]]":
    """CLI color spec → ``RenderConfig.background``: ``"white"``,
    ``"black"`` or ``"r,g,b"`` floats in [0, 1]; None passes through."""
    if spec is None:
        return None
    named = {"white": (1.0, 1.0, 1.0), "black": (0.0, 0.0, 0.0)}
    if spec.lower() in named:
        return named[spec.lower()]
    parts = [float(p) for p in spec.split(",")]
    if len(parts) != 3 or not all(0.0 <= p <= 1.0 for p in parts):
        raise ValueError(
            f"background {spec!r}: expected 'white', 'black', or r,g,b "
            "floats in [0, 1]"
        )
    return tuple(parts)
