"""Blocked bf16 GEMM: (M, K) · (K, N), bf16 inputs, f32 accumulation and
output.

Counterpart of ``gaussianrenderer_tpu/ops/pallas/matmul.py``
(``matmul_pallas``), the GEMM benchmark's kernel (``apps/matrix_test``).
``csrc/matmul.cu`` holds one product kernel, ``wgmma`` fed by TMA,
persistent over 128×256 tiles (128×64 where those would leave SMs idle),
and two routes into it: ``sm90`` for every shape TMA can describe, and
``packed`` for the rest, which first copies each operand TMA cannot
describe into scratch with rows padded to a multiple of 8 elements (one
pack kernel); :func:`gemm_kernel` picks the route from shape and
alignment alone. ``bm``/``bn``/``bk`` are the TPU
kernel's VMEM blocking, tuned for the TPU v5e, and here only keep its
contract: a shape that is not a multiple of them raises ``ValueError``.

``matmul_blocked`` launches a kernel for CUDA tensors and runs
:func:`matmul_blocked_plain` for CPU tensors; nothing falls back.
"""

from __future__ import annotations

import torch

from gaussianrenderer_tpu_torch import _build


def _check(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(
            f"matmul: need (M, K) and (K, N) matrices, got {tuple(a.shape)} and "
            f"{tuple(b.shape)}"
        )
    (m, k), (kb, n) = a.shape, b.shape
    if k != kb:
        raise ValueError(
            f"matmul: need (M, K) and (K, N) matrices, got {(m, k)} and {(kb, n)}"
        )
    if min(bm, bn, bk) < 1 or m % bm or n % bn or k % bk:
        raise ValueError(
            f"matmul: ({m}, {k}) x ({k}, {n}) is not a multiple of the blocks "
            f"(bm, bn, bk) = ({bm}, {bn}, {bk}): pad to block multiples"
        )
    return m, n, k


def _tma_ok(x: torch.Tensor) -> bool:
    """TMA can read the contiguous bf16 matrix ``x`` in place: its rows
    are a multiple of 16 bytes and its base is 16-byte aligned."""
    return x.shape[1] % 8 == 0 and x.data_ptr() % 16 == 0


def _padded(cols: int) -> int:
    return -(-cols // 8) * 8


def gemm_kernel(a: torch.Tensor, b: torch.Tensor) -> str:
    """The route that multiplies ``a`` (M, K) by ``b`` (K, N): ``"sm90"``
    where TMA can describe both operands (16-byte row strides, K and N
    multiples of 8, and 16-byte-aligned bases), else ``"packed"``."""
    return "sm90" if _tma_ok(a) and _tma_ok(b) else "packed"


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


_lib = None


def _load():
    global _lib
    _lib = _build.load("matmul")
    return _lib


def _launch(lib, a: int, b: int, c: int, m: int, n: int, k: int, a_len: int, b_len: int,
            card: int) -> int:
    """One ``gr_matmul`` call on the current stream of ``card``, the
    current device. The operands TMA cannot read in place (``a_len`` and
    ``b_len`` bf16 elements of padded rows, 0 for one TMA reads) are
    packed into one scratch, A's rows, then B's: a block of the caching
    allocator (512-byte aligned), taken raw, with no tensor around it, to
    keep the call's host side short, and handed back once the kernels are
    enqueued, since the allocator gives it out again only in this
    stream's order, after the kernels that read it."""
    stream = torch._C._cuda_getCurrentRawStream(card)
    if not (a_len or b_len):
        return lib.gr_matmul(a, b, c, m, n, k, None, None, stream)
    scratch = torch._C._cuda_cudaCachingAllocator_raw_alloc(2 * (a_len + b_len), stream)
    try:
        return lib.gr_matmul(a, b, c, m, n, k, scratch if a_len else None,
                             scratch + 2 * a_len if b_len else None, stream)
    finally:
        torch._C._cuda_cudaCachingAllocator_raw_delete(scratch)


def matmul_blocked(
    a: torch.Tensor, b: torch.Tensor, bm: int = 512, bn: int = 1024, bk: int = 1024
) -> torch.Tensor:
    """``a @ b`` as an (M, N) f32 tensor, from bf16 (M, K) and (K, N).

    CUDA tensors take the route :func:`gemm_kernel` names (counted in
    ``launches`` and in ``launches_sm90`` or ``launches_packed``); CPU
    tensors run :func:`matmul_blocked_plain`.

    The harness times one call at a time, so the CUDA path keeps its host
    side to the checks, the output's allocation, the packed route's
    scratch and one C call, as ``ops/cuda/lookup.table_lookup`` does: the
    library is loaded once, the current card and its stream are read raw,
    and only tensors on another card than the current one pay for a
    device switch.
    """
    if not a.is_cuda:
        if a.device.type == "cpu":
            return matmul_blocked_plain(a, b, bm, bn, bk)
        raise ValueError(f"matmul: unsupported device {a.device}")
    m, n, k = _check(a, b, bm, bn, bk)
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError("matmul: inputs must be bfloat16")
    card = a.get_device()
    if not (b.is_cuda and b.get_device() == card and a.is_contiguous()
            and b.is_contiguous()):
        raise ValueError("matmul: inputs must be contiguous and on one device")
    if not (m and n and k):
        return torch.zeros((m, n), dtype=torch.float32, device=a.device)
    lib = _lib or _load()
    out = a.new_empty((m, n), dtype=torch.float32)
    a_len = 0 if _tma_ok(a) else m * _padded(k)
    b_len = 0 if _tma_ok(b) else k * _padded(n)
    args = (lib, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, a_len, b_len, card)
    if torch._C._cuda_getDevice() == card:
        rc = _launch(*args)
    else:
        with torch.cuda.device(card):
            rc = _launch(*args)
    kernel = "packed" if a_len or b_len else "sm90"
    if rc != 0:
        raise RuntimeError(
            f"matmul {kernel} kernel launch failed: "
            f"{lib.gr_cuda_error_string(rc).decode()} (cudaError {rc}; M, N, K = {m}, {n}, {k})"
        )
    matmul_blocked.launches += 1
    if kernel == "sm90":
        matmul_blocked.launches_sm90 += 1
    else:
        matmul_blocked.launches_packed += 1
    return out


#: Kernel launches made through ``matmul_blocked`` in this process: all,
#: and those of each route.
matmul_blocked.launches = 0
matmul_blocked.launches_sm90 = 0
matmul_blocked.launches_packed = 0
