"""Fixed-order segment sum: the transpose of the training path's row
gather ``feats[ids]``.

``segment_sum(rows, ids, n)`` returns the (n, D) sums of the rows of each
id, each sum taken over its rows in their index order, starting from 0:
the order in which the CPU's ``index_add_`` adds them, so the two agree
bit for bit. ``index_add_`` on a CUDA tensor adds with float atomics,
whose order changes from run to run; this sum has one order, so a
training step on the card gives the same gradient every time.

The rows are grouped by a stable argsort of ``ids`` and located by a
search of the sorted ids (both exact integer work, on the device, with
no host wait). CUDA tensors then launch ``csrc/segment_sum.cu`` (counted
in ``launches``); CPU tensors run :func:`segment_sum_plain`, the same
sums in plain PyTorch, one rank of every segment at a time. Nothing falls
back: a CUDA tensor launches the kernel or raises. The kernel replaces
no TPU kernel: the JAX package's transpose is XLA's sort and cumsum
(``gaussianrenderer_tpu/ops/compositing.py`` ``_gather_rows_seg_bwd``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from gaussianrenderer_tpu_torch import _build


def segments(ids: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, offsets)``: the stable argsort of ``ids`` (M,) and the
    (n + 1,) int64 bounds of each id's run in it, so the rows of id ``s``
    are ``order[offsets[s]:offsets[s + 1]]`` in index order."""
    ids = ids.to(torch.int64)
    order = torch.argsort(ids, stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int64, device=ids.device)
    return order, torch.searchsorted(ids[order], bounds)


def _check(rows: torch.Tensor, ids: torch.Tensor) -> None:
    if rows.dim() != 2 or rows.dtype != torch.float32:
        raise ValueError("segment_sum: rows must be (M, D) float32")
    if ids.dim() != 1 or ids.shape[0] != rows.shape[0]:
        raise ValueError("segment_sum: ids must be (M,), one per row")


def segment_sum_plain(rows: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """The segment sum in plain PyTorch on the tensors' own device: each
    segment's k-th row is added in step k, so every sum is ``((0 + r_0) +
    r_1) + ...`` in index order, as the kernel adds. Reads the longest
    segment's length on the host."""
    _check(rows, ids)
    order, offsets = segments(ids, n)
    counts = offsets[1:] - offsets[:-1]
    out = rows.new_zeros((n, rows.shape[1]))
    longest = int(counts.max()) if n else 0
    for k in range(longest):
        seg = torch.nonzero(counts > k).squeeze(1)
        out[seg] += rows[order[offsets[seg] + k]]
    return out


def segment_sum(rows: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n, D) f32: ``out[s] = Σ rows[j]`` over ``ids[j] == s`` in
    increasing ``j``, from ``rows`` (M, D) float32 and ``ids`` (M,) int64
    or int32 in ``[0, n)``. CUDA tensors launch the kernel (counted in
    ``launches``); CPU tensors run :func:`segment_sum_plain`."""
    dev = rows.device
    if dev.type == "cpu":
        return segment_sum_plain(rows, ids, n)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {dev}")
    _check(rows, ids)
    if ids.device != dev:
        raise ValueError("segment_sum: rows and ids must be on one device")
    rows = rows.contiguous()
    order, offsets = segments(ids, n)
    out = rows.new_empty((n, rows.shape[1]))
    if n == 0:
        return out
    lib = _build.load("segment_sum")
    with torch.cuda.device(dev):
        rc = lib.gr_segment_sum(rows.data_ptr(), rows.shape[1], order.data_ptr(),
                                offsets.data_ptr(), n, out.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            "segment_sum kernel launch failed: "
            f"{lib.gr_cuda_error_string(rc).decode()} (cudaError {rc}; n = {n})"
        )
    segment_sum.launches += 1
    return out


#: Kernel launches made through ``segment_sum`` in this process.
segment_sum.launches = 0
