"""The training compositor's share of its roofline, percent: the least
time for the first checked step's frame, forward and backward
(``_counts.train_compositor_least_s``, counts from the reference), over
the compositor kernels' device time in that step."""

from benchmark import core
from benchmark.metrics import _counts


def read(rec: core.Record):
    return _counts.share_pct(rec.roofline, lambda r: _counts.train_compositor_least_s(
        r["pairs"], r["instances"], r["pixels"], r["tiles"]))
