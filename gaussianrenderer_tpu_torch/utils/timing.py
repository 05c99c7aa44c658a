"""Timing: EMA frame timer and device-time measurement.

On the card a kernel's time is read from two CUDA events around many
back-to-back calls: torch returns before the device finishes, and the
events are recorded on the same stream as the work, so the host's own
overheads and the wait for the result are not in the reading.
"""

from __future__ import annotations

import statistics
import time
from typing import Optional

import torch

from gaussianrenderer_tpu_torch._device import resolve_device


class FrameTimer:
    """EMA ms/frame + FPS (reference ``cull_sort_test.cpp:17-18,53-63``)."""

    def __init__(self, alpha: float = 0.1, report_every: int = 60):
        self.alpha = alpha
        self.report_every = report_every
        self.ema_ms: Optional[float] = None
        self.frames = 0
        self._last: Optional[float] = None

    def tick(self) -> Optional[str]:
        now = time.perf_counter()
        if self._last is not None:
            ms = (now - self._last) * 1e3
            self.ema_ms = (
                ms
                if self.ema_ms is None
                else self.alpha * ms + (1 - self.alpha) * self.ema_ms
            )
        self._last = now
        self.frames += 1
        if self.ema_ms is not None and self.frames % self.report_every == 0:
            return (
                f"frame {self.frames}: {self.ema_ms:.3f} ms/frame "
                f"({1000.0 / self.ema_ms:.1f} FPS)"
            )
        return None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_floor(reps: int = 7, device="cuda") -> float:
    """Median host round trip of a trivial op on ``device`` followed by a
    synchronize, ms: what any host-clock reading of one call includes."""
    dev = resolve_device(device)
    x = torch.zeros((8, 128), device=dev)
    _sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        x + 1.0
        _sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            return a.device
    return torch.device("cpu")


def device_time(
    fn,
    *args,
    iters: int = 10,
    floor: Optional[float] = None,
    reps: int = 3,
    perturb_ints: bool = True,
) -> float:
    """Per-call time of ``fn(*args)`` in ms: the median over ``reps`` of
    ``iters`` back-to-back calls, after one warm-up call.

    With a CUDA tensor among ``args`` the reading comes from two CUDA
    events around the calls; otherwise from the host clock around calls
    that run to completion. ``floor`` and ``perturb_ints`` are accepted
    and inert: the JAX package subtracts a sync floor from a host-clock
    reading of a jitted loop, and perturbs the inputs so that XLA cannot
    hoist the call out of that loop; eager calls timed by events need
    neither.
    """
    del floor, perturb_ints
    dev = _device_of(args)
    fn(*args)
    _sync(dev)
    ts = []
    for _ in range(reps):
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            with torch.cuda.device(dev):
                e0.record()
                for _ in range(iters):
                    fn(*args)
                e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts) / iters
