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


def table_lookup(
    table: torch.Tensor, idx: torch.Tensor, *, r: int = 128, q: int = 128
) -> torch.Tensor:
    """``f32(bf16(table))[clip(idx, 0, M − 1)]`` as an (N,) f32 tensor.

    ``table`` is (M,) float32 with M ≤ r·q (the TPU kernel's (r, q) view;
    here only that bound is kept), ``idx`` (N,) int32 or int64. CUDA
    tensors launch the kernel (counted in ``launches``); CPU tensors run
    :func:`table_lookup_plain`.
    """
    dev = table.device
    if dev.type == "cpu":
        return table_lookup_plain(table, idx, r=r, q=q)
    if dev.type != "cuda":
        raise ValueError(f"table_lookup: unsupported device {dev}")
    m = table.shape[0]
    _check_view(m, r, q)
    checks = [
        (table.dtype == torch.float32 and table.dim() == 1, "table must be (M,) float32"),
        (idx.dtype in (torch.int32, torch.int64) and idx.dim() == 1,
         "idx must be (N,) int32 or int64"),
        (idx.device == dev and table.is_contiguous() and idx.is_contiguous(),
         "inputs must be contiguous and on one device"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"table_lookup: {msg}")
    lib = _build.load("lookup")
    n = idx.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gr_table_lookup(
            table.data_ptr(), m, idx.data_ptr(), idx.element_size(), n,
            out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "lookup kernel launch failed: "
            f"{lib.gr_cuda_error_string(rc).decode()} (cudaError {rc}; M = {m})"
        )
    table_lookup.launches += 1
    return out


#: Kernel launches made through ``table_lookup`` in this process.
table_lookup.launches = 0
