"""The training compositor (``csrc/tile_train.cu``), forward and backward:
its kernels' device milliseconds per step in the traced window (profiler)."""

from benchmark import core
from benchmark.metrics import _counts


def read(rec: core.Record):
    s = core.kernel_seconds(rec.kernel_s, _counts.is_train_compositor)
    return None if s is None or not rec.trace_units else 1e3 * s / rec.trace_units
