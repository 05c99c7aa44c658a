"""Small-table lookup: ``table[clip(idx)]`` through a bf16 table.

Counterpart of ``gaussianrenderer_tpu/ops/pallas/lookup.py``. The TPU
kernel reads the table by a one-hot MXU matmul because gathers are
scalar-bound there; the card gathers freely, so the CUDA kernel
(``csrc/lookup.cu``) stages the table in shared memory and gathers.
Both keep the TPU kernel's rounding: the table passes through bf16
(round to nearest even), so callers whose values must not round down
pre-round them up with :func:`bf16_ceil`.

``table_lookup`` launches the kernel for CUDA tensors and runs
:func:`table_lookup_plain` for CPU tensors; nothing falls back.
"""

from __future__ import annotations

import torch

from gaussianrenderer_tpu_torch import _build


def bf16_ceil(x: torch.Tensor) -> torch.Tensor:
    """f32 → the next bf16 value at or above it, for non-negative finite
    inputs (add the largest low-mantissa value, then truncate), returned
    as f32. The u32 bit arithmetic is carried in int64."""
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    up = (bits + 0xFFFF) & 0xFFFF0000
    up = torch.where(up >= 2**31, up - 2**32, up).to(torch.int32)
    return up.view(torch.float32)


def _check_view(m: int, r: int, q: int) -> None:
    if m < 1:
        raise ValueError("table_lookup: the table is empty")
    if m > r * q:
        raise ValueError(f"table_lookup: table of {m} entries exceeds the {r}x{q} view")


def table_lookup_plain(
    table: torch.Tensor, idx: torch.Tensor, *, r: int = 128, q: int = 128
) -> torch.Tensor:
    """The lookup in plain PyTorch on the tensors' own device: (N,) f32."""
    m = table.shape[0]
    _check_view(m, r, q)
    tab = table.to(torch.bfloat16).to(torch.float32)
    return tab[torch.clamp(idx.to(torch.int64), 0, m - 1)]


#: Bytes of each index type the kernel reads.
_INDEX_BYTES = {torch.int32: 4, torch.int64: 8}
#: The kernel's library, once loaded (``_build.load`` takes a lock).
_lib = None


def _load():
    global _lib
    _lib = _build.load("lookup")
    return _lib


def table_lookup(
    table: torch.Tensor, idx: torch.Tensor, *, r: int = 128, q: int = 128
) -> torch.Tensor:
    """``f32(bf16(table))[clip(idx, 0, M − 1)]`` as an (N,) f32 tensor.

    ``table`` is (M,) float32 with M ≤ r·q (the TPU kernel's (r, q) view;
    here only that bound is kept), ``idx`` (N,) int32 or int64. CUDA
    tensors launch the kernel (counted in ``launches``); CPU tensors run
    :func:`table_lookup_plain`.

    The CUDA path runs twice a culled frame, whose host side is its
    bottleneck, so it keeps host work to the checks, one allocation and
    one C call: the library is loaded once, and the current card (which
    PyTorch caches, where the CUDA runtime's query costs microseconds)
    and its stream are read raw; only tensors on another card than the
    current one pay for a device switch.
    """
    if not table.is_cuda:
        if table.device.type == "cpu":
            return table_lookup_plain(table, idx, r=r, q=q)
        raise ValueError(f"table_lookup: unsupported device {table.device}")
    m = table.shape[0]
    if not 0 < m <= r * q:
        _check_view(m, r, q)
    if table.dtype != torch.float32 or table.dim() != 1:
        raise ValueError("table_lookup: table must be (M,) float32")
    width = _INDEX_BYTES.get(idx.dtype)
    if width is None or idx.dim() != 1:
        raise ValueError("table_lookup: idx must be (N,) int32 or int64")
    card = table.get_device()
    if not (idx.is_cuda and idx.get_device() == card and table.is_contiguous()
            and idx.is_contiguous()):
        raise ValueError("table_lookup: inputs must be contiguous and on one device")
    n = idx.shape[0]
    out = table.new_empty(n)
    if n == 0:
        return out
    lib = _lib or _load()
    if torch._C._cuda_getDevice() == card:
        rc = lib.gr_table_lookup(table.data_ptr(), m, idx.data_ptr(), width, n,
                                 out.data_ptr(), torch._C._cuda_getCurrentRawStream(card))
    else:
        with torch.cuda.device(card):
            rc = lib.gr_table_lookup(table.data_ptr(), m, idx.data_ptr(), width, n,
                                     out.data_ptr(), torch._C._cuda_getCurrentRawStream(card))
    if rc != 0:
        raise RuntimeError(
            "lookup kernel launch failed: "
            f"{lib.gr_cuda_error_string(rc).decode()} (cudaError {rc}; M = {m})"
        )
    table_lookup.launches += 1
    return out


#: Kernel launches made through ``table_lookup`` in this process.
table_lookup.launches = 0
