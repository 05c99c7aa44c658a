"""Fixed-order segment sum: the transpose of the training path's row
gather ``feats[ids]``.

``segment_sum(rows, ids, n)`` returns the (n, D) sums of the rows of each
id, each sum taken over its rows in their index order, starting from 0:
the order in which the CPU's ``index_add_`` adds them, so the two agree
bit for bit. ``index_add_`` on a CUDA tensor adds with float atomics,
whose order changes from run to run; this sum has one order, so a
training step on the card gives the same gradient every time.

Both entry points take the same ``(order, offsets)``: segment ``s`` is
the rows ``order[offsets[s]:offsets[s + 1]]``, added in that order.
:func:`segment_sum_ordered` takes them from its caller; the training
gather passes the tile assignment's ``segment_slot`` and
``segment_start`` (``ops/tiling.py``), which the emission already knows,
so its transpose neither sorts nor searches. :func:`segment_sum` finds
them from any ``ids`` by a stable argsort and a search of the sorted ids
(:func:`segments`, exact integer work on the device with no host wait).
CUDA tensors then launch ``csrc/segment_sum.cu`` (counted in
``segment_sum.launches`` by both); CPU tensors run the plain versions,
the same sums in plain PyTorch, one rank of every segment at a time.
Nothing falls back: a CUDA tensor launches the kernel or raises. The
kernel replaces no TPU kernel: the JAX package's transpose is XLA's sort
and cumsum (``gaussianrenderer_tpu/ops/compositing.py``
``_gather_rows_seg_bwd``).
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


def _check_ordered(rows: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor) -> None:
    _check(rows, order)
    if offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError("segment_sum: offsets must be (n + 1,)")
    for t in (order, offsets):
        if t.dtype not in (torch.int32, torch.int64):
            raise ValueError("segment_sum: order and offsets must be int32 or int64")


def segment_sum_ordered_plain(rows: torch.Tensor, order: torch.Tensor,
                              offsets: torch.Tensor) -> torch.Tensor:
    """The segment sum in plain PyTorch on the tensors' own device: each
    segment's k-th row is added in step k, so every sum is ``((0 + r_0) +
    r_1) + ...`` in the given order, as the kernel adds. Reads the longest
    segment's length on the host."""
    _check_ordered(rows, order, offsets)
    order, offsets = order.to(torch.int64), offsets.to(torch.int64)
    n = offsets.shape[0] - 1
    counts = offsets[1:] - offsets[:-1]
    out = rows.new_zeros((n, rows.shape[1]))
    longest = int(counts.max()) if n else 0
    for k in range(longest):
        seg = torch.nonzero(counts > k).squeeze(1)
        out[seg] += rows[order[offsets[seg] + k]]
    return out


def segment_sum_plain(rows: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`segment_sum_ordered_plain` on the rows of each id in index
    order (:func:`segments`)."""
    _check(rows, ids)
    return segment_sum_ordered_plain(rows, *segments(ids, n))


_lib = None


def _load():
    global _lib
    _lib = _build.load("segment_sum")
    return _lib


def _launch(rows: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, with int32 ``order`` and ``offsets``.
    Once a training step, so the host side is the checks, one allocation
    and one C call (the current card and its stream read raw, as
    ``ops/cuda/lookup.table_lookup`` does)."""
    card = rows.get_device()
    if not (order.is_cuda and offsets.is_cuda and order.get_device() == card
            and offsets.get_device() == card):
        raise ValueError("segment_sum: rows, order and offsets must be on one device")
    if rows.shape[0] >= 2**31:
        raise ValueError(f"segment_sum: {rows.shape[0]} rows exceed the int32 index")
    rows = rows.contiguous()
    order = order.to(torch.int32).contiguous()
    offsets = offsets.to(torch.int32).contiguous()
    n = offsets.shape[0] - 1
    out = rows.new_empty((n, rows.shape[1]))
    if n == 0:
        return out
    lib = _lib or _load()
    args = (rows.data_ptr(), rows.shape[1], order.data_ptr(), offsets.data_ptr(), n,
            out.data_ptr())
    if torch._C._cuda_getDevice() == card:
        rc = lib.gr_segment_sum(*args, torch._C._cuda_getCurrentRawStream(card))
    else:
        with torch.cuda.device(card):
            rc = lib.gr_segment_sum(*args, torch._C._cuda_getCurrentRawStream(card))
    if rc != 0:
        raise RuntimeError(
            "segment_sum kernel launch failed: "
            f"{lib.gr_cuda_error_string(rc).decode()} (cudaError {rc}; n = {n})"
        )
    segment_sum.launches += 1
    return out


def _on_cuda(rows: torch.Tensor) -> bool:
    if rows.is_cuda:
        return True
    if rows.device.type != "cpu":
        raise ValueError(f"segment_sum: unsupported device {rows.device}")
    return False


def segment_sum_ordered(rows: torch.Tensor, order: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """(n, D) f32: ``out[s] = Σ rows[order[k]]`` over ``k`` in
    ``[offsets[s], offsets[s + 1])`` in increasing ``k``, from ``rows``
    (M, D) float32, ``order`` (M,) and ``offsets`` (n + 1,) int32 or
    int64. CUDA tensors launch the kernel (counted in
    ``segment_sum.launches``); CPU tensors run
    :func:`segment_sum_ordered_plain`."""
    if not _on_cuda(rows):
        return segment_sum_ordered_plain(rows, order, offsets)
    _check_ordered(rows, order, offsets)
    return _launch(rows, order, offsets)


def segment_sum(rows: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n, D) f32: ``out[s] = Σ rows[j]`` over ``ids[j] == s`` in
    increasing ``j``, from ``rows`` (M, D) float32 and ``ids`` (M,) int64
    or int32 in ``[0, n)``. CUDA tensors launch the kernel (counted in
    ``launches``); CPU tensors run :func:`segment_sum_plain`."""
    if not _on_cuda(rows):
        return segment_sum_plain(rows, ids, n)
    _check(rows, ids)
    if ids.device != rows.device:
        raise ValueError("segment_sum: rows and ids must be on one device")
    return _launch(rows, *segments(ids, n))


#: Kernel launches made through ``segment_sum`` and ``segment_sum_ordered``
#: in this process.
segment_sum.launches = 0
