"""The yardstick of the roofline shares: the card's peaks and the least
work the training compositor needs for a frame, from counts that the benchmark's
own reference makes (``benchmark/reference/render.py``): the instances
(one per splat and tile its box touches) and the blending pairs (a pixel
still open, T ≥ 1e-3, inside a splat's box, with alpha ≥ 1e-3).

A share is the least time for that work, the larger of its operations
over the float32 peak and its bytes over the memory bandwidth, divided by
the kernels' device time. The counts do not depend on how a kernel is
written, so a change to a kernel moves only its time.
"""

from __future__ import annotations

from typing import Optional

#: Kernel names (substrings) of the training compositor's passes
#: (``csrc/tile_train.cu``).
TRAIN_COMPOSITOR_KERNELS = ("row_tiles_kernel", "fwd_products_kernel", "fwd_scan_kernel",
                            "fwd_composite_kernel", "fwd_reduce_kernel", "bwd_totals_kernel",
                            "bwd_suffix_kernel", "bwd_grads_kernel")


def is_train_compositor(name: str) -> bool:
    return any(k in name for k in TRAIN_COMPOSITOR_KERNELS)


#: NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3.
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12

#: One blending pair, front to back: dx, dy (2); md² = (A·dx + B·dy)·dx
#: + C·dy·dy (7); the exponent's scale, exp, times opacity, the 0.99
#: clamp (4); the weight alpha·T (1); three colour sums (6); T·(1 − α) (2).
BLEND_OPS = 22
#: The same pair backward: alpha again (13); the colour gradient against
#: the pixel's cotangent and the running suffix (12); alpha's gradient
#: through the clamp and exp (4); the conic's, centre's, opacity's and
#: colour's gradient sums (11).
BLEND_BACKWARD_OPS = 40
#: A training feature row: 16 float32.
FEATURE_ROW_BYTES = 64
#: Per tile: its start and count (int32).
TILE_RANGE_BYTES = 8
#: Per pixel: three float32 colour channels.
PIXEL_BYTES = 12


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_S)


def train_compositor_least_s(pairs: int, instances: int, pixels: int, tiles: int) -> float:
    """The training compositor, forward and backward: features read by
    each pass and their gradients written once, the frame written and its
    cotangent read once, each blending pair computed forward and back."""
    return least_seconds(pairs * (BLEND_OPS + BLEND_BACKWARD_OPS),
                         instances * 3 * FEATURE_ROW_BYTES + 2 * tiles * TILE_RANGE_BYTES
                         + 2 * pixels * PIXEL_BYTES)


def share_pct(readings, least) -> Optional[float]:
    """Mean share, in percent, over the readings that hold both a kernel
    time and the reference's counts; None where none does."""
    shares = [100.0 * least(r) / r["kernel_s"] for r in readings
              if r.get("kernel_s") and "pairs" in r]
    return sum(shares) / len(shares) if shares else None
