"""The optimizer (``train.Adam``): CUDA-event milliseconds around the
update and its apply, mean."""

from benchmark import core


def read(rec: core.Record):
    return core.mean(rec.spans_ms.get("optimizer", []))
