"""Bitonic block sort: each ``run``-sized block of a (9, C) u32 matrix
sorted by row 0, with the 8 payload rows following their keys.

Counterpart of ``gaussianrenderer_tpu/ops/pallas/block_sort.py``
(``block_sort_runs``), the run-formation phase of a merge sort that no
render or training path calls. The network and its tie rule are the TPU
kernel's: a pair swaps only when its keys are strictly out of order, so
the sort is not stable, and equal keys may leave their payload rows in
another order than a stable sort would. Both versions here reproduce the
TPU kernel's output bit for bit, payloads included.

u32 values are carried in int64 tensors; the kernel
(``csrc/block_sort.cu``) reads and writes those int64 words and compares
the low 32 bits of the key row as u32. ``block_sort_runs`` launches it
for CUDA tensors and runs :func:`block_sort_runs_plain` for CPU tensors;
nothing falls back.
"""

from __future__ import annotations

import torch

from gaussianrenderer_tpu_torch import _build

ROWS = 9  # key + 8 payloads
#: Longest run the kernel sorts (its (key, index) pairs fill 128 KB of
#: shared memory); the plain version takes any.
MAX_KERNEL_RUN = 16384


def _check(x: torch.Tensor, run: int) -> int:
    if x.dim() != 2 or x.shape[0] != ROWS:
        raise ValueError(f"block_sort: need a ({ROWS}, C) matrix, got {tuple(x.shape)}")
    c = x.shape[1]
    if run < 256 or run & (run - 1):
        raise ValueError(f"block_sort: run must be a power of two >= 256, got {run}")
    if c % run:
        raise ValueError(f"block_sort: C = {c} is not a multiple of run = {run}")
    return c


def block_sort_runs_plain(x: torch.Tensor, run: int = 2048) -> torch.Tensor:
    """The same network in plain PyTorch on the tensor's own device: one
    vectorised compare-exchange per substage over all runs at once."""
    c = _check(x, run)
    rows = x.to(torch.int64).reshape(ROWS, c // run, run)
    idx = torch.arange(run, device=x.device)
    log_run = run.bit_length() - 1
    for k in range(1, log_run + 1):
        asc = ((idx >> k) & 1) == 0
        for j in range(k - 1, -1, -1):
            partner = idx ^ (1 << j)
            upper = ((idx >> j) & 1) == 1
            want_low = upper != asc
            pr = rows[:, :, partner]
            key, pk = rows[0], pr[0]
            take_self = torch.where(want_low, key <= pk, key >= pk)
            rows = torch.where(take_self, rows, pr)
    return rows.reshape(ROWS, c)


def block_sort_runs(x: torch.Tensor, run: int = 2048) -> torch.Tensor:
    """Sort each ``run``-sized block of ``x`` (9, C) by row 0.

    ``x`` holds u32 values as int64; C must be a multiple of ``run``, and
    ``run`` a power of two ≥ 256 (and ≤ ``MAX_KERNEL_RUN`` on the card).
    CUDA tensors launch the kernel (counted in ``launches``); CPU tensors
    run :func:`block_sort_runs_plain`. Returns (9, C) int64.
    """
    dev = x.device
    if dev.type == "cpu":
        return block_sort_runs_plain(x, run)
    if dev.type != "cuda":
        raise ValueError(f"block_sort: unsupported device {dev}")
    c = _check(x, run)
    if run > MAX_KERNEL_RUN:
        raise ValueError(
            f"block_sort: run {run} exceeds the kernel's largest, {MAX_KERNEL_RUN} "
            "(a run's keys and indices must fit in one block's shared memory)"
        )
    if x.dtype != torch.int64:
        raise ValueError("block_sort: x must hold u32 values as int64")
    if c == 0:
        return x.clone()
    x = x.contiguous()
    res = torch.empty_like(x)
    lib = _build.load("block_sort")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gr_block_sort(x.data_ptr(), res.data_ptr(), c, run, stream)
    if rc != 0:
        raise RuntimeError(
            "block sort kernel launch failed: "
            f"{lib.gr_cuda_error_string(rc).decode()} (cudaError {rc}; C = {c}, run = {run})"
        )
    block_sort_runs.launches += 1
    return res


#: Kernel launches made through ``block_sort_runs`` in this process.
block_sort_runs.launches = 0
