"""JAX's default random draw, ``jax.random.{bits, uniform, normal}(
jax.random.PRNGKey(seed), shape)``, on the card and on the CPU.

A densify episode samples each refilled splat inside its donor from an
(n, 3) standard normal; the JAX package draws it from ``PRNGKey(seed)``.
A ``torch.Generator`` gives other numbers from the same seed (an MT19937
on the CPU, Philox on CUDA), so the port draws JAX's own: one seed gives
one fit in both packages and on both devices.

- bits: threefry2x32 (20 rounds) on the key ``(0, seed mod 2^32)`` (what
  ``PRNGKey`` makes with x64 off) and the counter ``(hi, lo)`` of each
  value's row-major flat index; a value is ``x0 ^ x1`` (JAX's
  partitionable threefry, its default);
- uniform on ``[nextafter(-1, 0), 1)``: ``bitcast(bits >> 9 | 0x3F800000)
  - 1``, times ``1 - lo``, plus ``lo`` (product and sum rounded apart),
  at least ``lo``;
- normal: ``f32(√2)·erf_inv(u)`` with XLA's f32 ``erf_inv`` polynomial
  (``w = -log1p(-u²)``, a degree-8 Horner in fused multiply-adds).

The bits and the uniforms equal JAX's bit for bit; the normals are within
4 ulp of JAX's (``log1p`` is the CPU's, or CUDA's, not XLA's). The bf16
normal draws 8 bits a value, runs the mantissa trick on 7 bits, the
uniform in bf16 and ``erf_inv`` in f32 rounded to bf16, as JAX does.

The ``*_plain`` functions run on any device in plain PyTorch: the 32-bit
words ride in int64 tensors masked to 32 bits (PyTorch has no shifts on
uint32), and each fused multiply-add goes through float64, rounded once
to float32. The wrappers :func:`random_bits`, :func:`uniform` and
:func:`normal` run the plain version on the CPU and launch
``csrc/prng.cu`` on a CUDA device (counted in ``launches``); nothing falls
back: a CUDA device launches the kernel or raises. The kernel replaces no
TPU kernel: ``jax.random.normal`` is XLA's elementwise code.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from gaussianrenderer_tpu_torch import _build
from gaussianrenderer_tpu_torch._device import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: XLA's f32 erf_inv coefficients (highest power first), for w < 5 and w ≥ 5.
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)

#: The kernel's modes (``csrc/prng.cu``).
_MODES = {"bits": 0, "uniform": 1, "normal": 2, "normal_bf16": 3}

#: Kernel launches made through the wrappers in this process.
launches = 0


def _shape(shape) -> Tuple[int, ...]:
    shape = tuple(int(s) for s in shape)
    if any(s < 0 for s in shape):
        raise ValueError(f"prng: negative dimension in shape {shape}")
    return shape


def _check_dtype(dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"prng: dtype {dtype} is not float32 or bfloat16")


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def random_bits_plain(seed: int, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.bits(PRNGKey(seed), shape, uint32)`` as an int64
    tensor of values in ``[0, 2^32)``."""
    shape = _shape(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    ks = (0, int(seed) & _MASK)
    ks = ks + (ks[0] ^ ks[1] ^ _PARITY,)
    x0 = ((idx >> 32) + ks[0]) & _MASK
    x1 = ((idx & _MASK) + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _MASK
    return (x0 ^ x1).reshape(shape)


def _float_bits(bits: torch.Tensor, dtype) -> torch.Tensor:
    """The mantissa trick: random mantissa bits under the exponent of 1.0,
    as a float in [1, 2) of ``dtype``."""
    if dtype == torch.float32:
        return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16)


def uniform_plain(seed: int, shape: Sequence[int], device="cpu",
                  dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform(PRNGKey(seed), shape, dtype, nextafter(-1, 0),
    1)``: the uniform that :func:`normal_plain` feeds to ``erf_inv``."""
    _check_dtype(dtype)
    floats = _float_bits(random_bits_plain(seed, shape, device), dtype) - 1.0
    # nextafter(-1, 0) in dtype.
    lo = torch.tensor(torch.finfo(dtype).eps / 2 - 1.0, dtype=dtype, device=device)
    # Rounded apart: a product, then a sum.
    return torch.maximum(lo, floats * (1.0 - lo) + lo)


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """``a·b + c`` of f32 tensors rounded once: the f32 product is exact
    in float64."""
    return (a.double() * b.double() + c).float()


def erf_inv_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` of an f32 tensor (``torch.erfinv`` is up to
    ~90 ulp away from it)."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coefficient(k):  # f32, as XLA's constants
        return torch.where(lt, _ERF_INV_LT5[k], _ERF_INV_GE5[k]).to(torch.float32)

    p = coefficient(0)
    for k in range(1, 9):
        p = _fma(p, w, coefficient(k).double())
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal_plain(seed: int, shape: Sequence[int], device="cpu",
                 dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(PRNGKey(seed), shape, dtype)`` for float32 or
    bfloat16: ``√2·erf_inv(u)`` of :func:`uniform_plain`, ``erf_inv`` in
    f32."""
    u = uniform_plain(seed, shape, device, dtype)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=device)
    return sqrt2 * erf_inv_plain(u.float()).to(dtype)


def _launch(seed: int, shape, device: torch.device, mode: str) -> torch.Tensor:
    global launches
    shape = _shape(shape)
    dtype = {"bits": torch.int32, "normal_bf16": torch.bfloat16}.get(mode, torch.float32)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _build.load("prng")
    with torch.cuda.device(device):
        rc = lib.gr_prng(int(seed) & _MASK, out.numel(), _MODES[mode], out.data_ptr(),
                         torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"prng kernel launch failed: {lib.gr_cuda_error_string(rc).decode()} "
            f"(cudaError {rc}; mode {mode}, shape {shape})"
        )
    launches += 1
    return out


def _device(device) -> torch.device:
    """``device`` checked: the CPU, or a CUDA device with its index (a
    CUDA device where there is none raises)."""
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"prng: unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def random_bits(seed: int, shape: Sequence[int], device="cuda") -> torch.Tensor:
    """JAX's random bits as int64 in ``[0, 2^32)``: the kernel on CUDA,
    :func:`random_bits_plain` on the CPU."""
    dev = _device(device)
    if dev.type == "cpu":
        return random_bits_plain(seed, shape, dev)
    return _launch(seed, shape, dev, "bits").to(torch.int64) & _MASK


def uniform(seed: int, shape: Sequence[int], device="cuda") -> torch.Tensor:
    """JAX's f32 uniform on ``[nextafter(-1, 0), 1)``: the kernel on CUDA,
    :func:`uniform_plain` on the CPU."""
    dev = _device(device)
    if dev.type == "cpu":
        return uniform_plain(seed, shape, dev)
    return _launch(seed, shape, dev, "uniform")


def normal(seed: int, shape: Sequence[int], device="cuda",
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(PRNGKey(seed), shape, dtype)``: the kernel on
    CUDA (one launch), :func:`normal_plain` on the CPU."""
    _check_dtype(dtype)
    dev = _device(device)
    if dev.type == "cpu":
        return normal_plain(seed, shape, dev, dtype)
    return _launch(seed, shape, dev, "normal" if dtype == torch.float32 else "normal_bf16")
