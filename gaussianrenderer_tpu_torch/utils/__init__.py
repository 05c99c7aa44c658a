"""Shared utilities: timing, JSONL benchmark sink, device-time measurement.

The JAX package's persistent compile cache has no counterpart here: the
port compiles only its CUDA sources, and ``_build.py`` keeps each built
library under a hash of its source and flags.
"""

from gaussianrenderer_tpu_torch.utils.jsonl import JsonlWriter, device_info
from gaussianrenderer_tpu_torch.utils.timing import FrameTimer, device_time, measure_floor

__all__ = [
    "FrameTimer",
    "JsonlWriter",
    "device_info",
    "device_time",
    "measure_floor",
]
