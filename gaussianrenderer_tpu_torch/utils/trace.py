"""Spans of the training step's layers, kept by ``torch.profiler``.

    from gaussianrenderer_tpu_torch.utils import trace

    with trace.enabled(), torch.profiler.profile(activities=[CPU, CUDA]) as prof:
        params, state, loss = step(params, state, cam, target)

``span(name)`` marks one layer of the program. With tracing off, the
default, it returns one shared null context, so a step pays well under a
microsecond a span; with it on, ``torch.profiler.record_function("gr." +
name)``. The profiler holds the spans on one clock with the kernels and
runtime calls, and links each launch to the host call that made it by its
correlation id, so the program keeps no store of its own.

``enabled()`` is the only switch. It is process-wide, not per thread:
the backward's spans (``gr.compositor.bwd``, ``gr.gather.bwd``) run on
autograd's device thread.

``host_read(site, t)`` is the program's explicit read of a device value
to the host, inside a ``gr.sync.<site>`` span: the host waits there for
the card to drain its queue.
"""

from __future__ import annotations

import contextlib

import torch

#: The prefix of every span's name in a profile.
PREFIX = "gr."

_NULL = contextlib.nullcontext()
_on = False


def span(name: str):
    """A context that marks the layer ``name`` while tracing is on."""
    if not _on:
        return _NULL
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def enabled():
    """Turn the spans on for the ``with`` block, in every thread."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def host_read(site: str, t: torch.Tensor) -> int:
    """``int(t)`` inside the span ``sync.<site>``."""
    with span("sync." + site):
        return int(t)
