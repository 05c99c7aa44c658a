"""Tiling and gather (``ops/tiling.py``, ``ops/compositing.py``): CUDA-event
milliseconds around ``build_sorted_instances`` + ``build_features`` +
``gather_sorted_features_seg``, mean."""

from benchmark import core


def read(rec: core.Record):
    return core.mean(rec.spans_ms.get("tiling_gather", []))
