"""Bitonic block sort: each ``run``-sized block of a (9, C) u32 matrix
sorted by row 0, with the 8 payload rows following their keys.

Counterpart of ``gaussianrenderer_tpu/ops/pallas/block_sort.py``
(``block_sort_runs``), the run-formation phase of a merge sort that no
render or training path calls. The network and its tie rule are the TPU
kernel's: a pair swaps only when its keys are strictly out of order, so
the sort is not stable, and equal keys may leave their payload rows in
another order than a stable sort would. Both versions here reproduce the
TPU kernel's output bit for bit, payloads included.

u32 values are carried in int64 tensors; the kernels
(``csrc/block_sort.cu``) read and write those int64 words and compare
the low 32 bits of the key row as u32. ``block_sort_runs`` launches them
for CUDA tensors and runs :func:`block_sort_runs_plain` for CPU tensors;
nothing falls back. Both take any run that is a power of two ≥ 256.
"""

from __future__ import annotations

import ctypes

import torch

from gaussianrenderer_tpu_torch import _build

ROWS = 9  # key + 8 payloads
#: Longest run one block sorts alone (8192 (key, index) pairs, 64 KB of
#: shared memory); longer runs take global passes and more launches, with
#: a (C,) int64 scratch.
MAX_BLOCK_RUN = 8192


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
    ``run`` a power of two ≥ 256. CUDA tensors launch the kernels (calls
    counted in ``launches``, kernels in ``kernel_launches``: one a call up
    to ``MAX_BLOCK_RUN``, 10 at run 65536); CPU tensors run
    :func:`block_sort_runs_plain`. Returns (9, C) int64.
    """
    dev = x.device
    if dev.type == "cpu":
        return block_sort_runs_plain(x, run)
    if dev.type != "cuda":
        raise ValueError(f"block_sort: unsupported device {dev}")
    c = _check(x, run)
    if x.dtype != torch.int64:
        raise ValueError("block_sort: x must hold u32 values as int64")
    if c == 0:
        return x.clone()
    x = x.contiguous()
    res = torch.empty_like(x)
    pairs = torch.empty(c, dtype=torch.int64, device=dev) if run > MAX_BLOCK_RUN else None
    lib = _build.load("block_sort")
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gr_block_sort(x.data_ptr(), res.data_ptr(),
                               None if pairs is None else pairs.data_ptr(), c, run,
                               stream, ctypes.byref(n))
    block_sort_runs.kernel_launches += n.value
    if rc != 0:
        raise RuntimeError(
            "block sort kernel launch failed: "
            f"{lib.gr_cuda_error_string(rc).decode()} (cudaError {rc}; C = {c}, run = {run})"
        )
    block_sort_runs.launches += 1
    return res


#: Calls of ``block_sort_runs`` that launched (``launches``) and the
#: kernels they launched (``kernel_launches``) in this process.
block_sort_runs.launches = block_sort_runs.kernel_launches = 0
