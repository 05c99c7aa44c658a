"""The train step: host milliseconds of each step call of the window, mean."""

from benchmark import core


def read(rec: core.Record):
    v = core.mean(rec.enqueue_s)
    return None if v is None else 1e3 * v
