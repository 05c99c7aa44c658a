"""Blocked bf16 GEMM: (M, K) · (K, N), bf16 inputs, f32 accumulation and
output.

Counterpart of ``gaussianrenderer_tpu/ops/pallas/matmul.py``
(``matmul_pallas``), the GEMM benchmark's kernel (``apps/matrix_test``).
``csrc/matmul.cu`` holds two CUDA kernels: ``sm90`` (``wgmma`` fed by TMA,
persistent, 128×256 tiles) for every shape TMA can describe, and ``wmma``
(128×128 tiles of ``mma.sync`` fragments) for the rest; :func:`gemm_kernel`
picks one from shape and alignment alone. ``bm``/``bn``/``bk`` are the TPU
kernel's VMEM blocking, tuned for the TPU v5e, and here only keep its
contract: a shape that is not a multiple of them raises ``ValueError``.

``matmul_blocked`` launches a kernel for CUDA tensors and runs
:func:`matmul_blocked_plain` for CPU tensors; nothing falls back.
"""

from __future__ import annotations

import torch

from gaussianrenderer_tpu_torch import _build


def _check(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"matmul: need (M, K) and (K, N) matrices, got {tuple(a.shape)} and "
            f"{tuple(b.shape)}"
        )
    m, k = a.shape
    n = b.shape[1]
    if min(bm, bn, bk) < 1 or m % bm or n % bn or k % bk:
        raise ValueError(
            f"matmul: ({m}, {k}) x ({k}, {n}) is not a multiple of the blocks "
            f"(bm, bn, bk) = ({bm}, {bn}, {bk}): pad to block multiples"
        )
    return m, n, k


def gemm_kernel(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel that multiplies ``a`` (M, K) by ``b`` (K, N): ``"sm90"``
    where TMA can describe both operands (16-byte row strides, K and N
    multiples of 8, and 16-byte-aligned bases), else ``"wmma"``."""
    k, n = b.shape
    if k % 8 or n % 8 or a.data_ptr() % 16 or b.data_ptr() % 16:
        return "wmma"
    return "sm90"


def matmul_blocked_plain(
    a: torch.Tensor, b: torch.Tensor, bm: int = 512, bn: int = 1024, bk: int = 1024
) -> torch.Tensor:
    """The product in plain PyTorch on the tensors' own device: f32 sums of
    ``a[:, kk].float() @ b[kk, :].float()`` over the ``bk`` slices of K."""
    m, n, k = _check(a, b, bm, bn, bk)
    out = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, bk):
        out += a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
    return out


def matmul_blocked(
    a: torch.Tensor, b: torch.Tensor, bm: int = 512, bn: int = 1024, bk: int = 1024
) -> torch.Tensor:
    """``a @ b`` as an (M, N) f32 tensor, from bf16 (M, K) and (K, N).

    CUDA tensors launch the kernel :func:`gemm_kernel` names (counted in
    ``launches`` and in ``launches_sm90`` or ``launches_wmma``); CPU tensors
    run :func:`matmul_blocked_plain`.
    """
    dev = a.device
    if dev.type == "cpu":
        return matmul_blocked_plain(a, b, bm, bn, bk)
    if dev.type != "cuda":
        raise ValueError(f"matmul: unsupported device {dev}")
    m, n, k = _check(a, b, bm, bn, bk)
    checks = [
        (a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16, "inputs must be bfloat16"),
        (b.device == dev and a.is_contiguous() and b.is_contiguous(),
         "inputs must be contiguous and on one device"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"matmul: {msg}")
    if min(m, n, k) == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=dev)
    lib = _build.load("matmul")
    kernel = gemm_kernel(a, b)
    launch = lib.gr_matmul_sm90 if kernel == "sm90" else lib.gr_matmul
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, stream)
    if rc != 0:
        raise RuntimeError(
            f"matmul {kernel} kernel launch failed: "
            f"{lib.gr_cuda_error_string(rc).decode()} (cudaError {rc}; M, N, K = {m}, {n}, {k})"
        )
    matmul_blocked.launches += 1
    if kernel == "sm90":
        matmul_blocked.launches_sm90 += 1
    else:
        matmul_blocked.launches_wmma += 1
    return out


#: Kernel launches made through ``matmul_blocked`` in this process: all,
#: and those of each kernel.
matmul_blocked.launches = 0
matmul_blocked.launches_sm90 = 0
matmul_blocked.launches_wmma = 0
