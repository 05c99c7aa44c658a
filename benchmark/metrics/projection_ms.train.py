"""Projection with autograd: CUDA-event milliseconds around
``to_scene`` + ``preprocess_gaussians`` on the first checked step's inputs, mean."""

from benchmark import core


def read(rec: core.Record):
    return core.mean(rec.spans_ms.get("projection", []))
