"""The SH view-dependent colour of every splat, forward and backward, as
one hand-written CUDA kernel pair (``csrc/sh_color.cu``).

:func:`sh_color` is the projection's colour step: the direction from the
camera to each splat, the SH basis to the configured degree, the three
channel sums, +0.5 and the clamp. CUDA tensors launch the forward kernel,
and under autograd the backward kernel too, through one
``torch.autograd.Function`` (each launch counted in
``sh_color.launches``). CPU tensors run the plain chain,
``ops/sh.view_color``, under autograd. Nothing falls back: a CUDA tensor
launches the kernel or raises.

On the card the colour and the coefficient gradient equal the plain
chain's bit for bit; the position gradient agrees with autograd's to
rounding (a sum of many terms in another order). The kernels replace no
TPU kernel: the JAX package's SH is plain ``jnp``, which XLA
fuses; eagerly, the plain chain is some 560 launches a training step at
degree 3, and autograd's transpose of each coefficient row writes a
zero-filled copy of the whole gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gaussianrenderer_tpu_torch import _build
from gaussianrenderer_tpu_torch.ops.sh import view_color

#: Stored SH degree of each coefficient width the kernels take.
_STORED_DEGREE = {3: 0, 12: 1, 27: 2, 48: 3}

_lib = None


def _load():
    global _lib
    _lib = _build.load("sh_color")
    return _lib


def _launch(fn: str, card: int, *args) -> None:
    """``lib.<fn>(*args, stream)`` on the current stream of ``card``; raises
    if the launch fails."""
    lib = _lib or _load()
    if torch._C._cuda_getDevice() == card:
        rc = getattr(lib, fn)(*args, torch._C._cuda_getCurrentRawStream(card))
    else:
        with torch.cuda.device(card):
            rc = getattr(lib, fn)(*args, torch._C._cuda_getCurrentRawStream(card))
    if rc != 0:
        raise RuntimeError(f"sh_color kernel launch failed: "
                           f"{lib.gr_cuda_error_string(rc).decode()} (cudaError {rc}; {fn})")
    sh_color.launches += 1


def _forward(positions, sh, cam, stored: int, degree: int) -> torch.Tensor:
    out = positions.new_empty((positions.shape[0], 3))
    if positions.shape[0]:
        _launch("gr_sh_color_fwd", positions.get_device(), positions.data_ptr(), sh.data_ptr(),
                cam.data_ptr(), positions.shape[0], stored, degree, out.data_ptr())
    return out


class _ShColor(torch.autograd.Function):
    """The kernel pair under autograd; the backward recomputes the
    direction, the basis and the colour (for the clamp's mask) from the
    saved inputs."""

    @staticmethod
    def forward(ctx, positions, sh, cam, stored, degree):
        ctx.save_for_backward(positions, sh, cam)
        ctx.stored, ctx.degree = stored, degree
        return _forward(positions, sh, cam, stored, degree)

    @staticmethod
    def backward(ctx, grad):
        positions, sh, cam = ctx.saved_tensors
        # At degree 0 the colour does not depend on the position.
        dpos = (torch.empty_like(positions)
                if ctx.needs_input_grad[0] and ctx.degree > 0 else None)
        dsh = torch.empty_like(sh) if ctx.needs_input_grad[1] else None
        n = positions.shape[0]
        if n and (dpos is not None or dsh is not None):
            grad = grad.contiguous()

            def ptr(t):
                return None if t is None else t.data_ptr()

            _launch("gr_sh_color_bwd", positions.get_device(), positions.data_ptr(),
                    sh.data_ptr(), cam.data_ptr(), grad.data_ptr(), n, ctx.stored, ctx.degree,
                    ptr(dsh), ptr(dpos))
        return dpos, dsh, None, None, None


def _on_cuda(sh: torch.Tensor) -> bool:
    if sh.is_cuda:
        return True
    if sh.device.type != "cpu":
        raise ValueError(f"sh_color: unsupported device {sh.device}")
    return False


def _degrees(sh: torch.Tensor, degree: int) -> Tuple[int, int]:
    """The stored degree of ``sh``'s width and the degree evaluated, at
    most the stored one (as ``eval_sh_columns`` takes it)."""
    stored = _STORED_DEGREE.get(sh.shape[1])
    if stored is None:
        raise ValueError(f"sh_color: {sh.shape[1]} coefficient columns; the kernel takes "
                         f"3, 12, 27 or 48 (SH degree 0 to 3)")
    return stored, max(0, min(int(degree), stored))


def sh_color(positions: torch.Tensor, sh: torch.Tensor, cam_position: torch.Tensor,
             degree: int) -> torch.Tensor:
    """(N, 3) float32 clamped colours of splats at ``positions`` (N, 3)
    with interleaved coefficients ``sh`` (N, 3·(deg+1)²), seen from
    ``cam_position`` (3,), to SH ``degree`` (at most the stored one).
    CUDA tensors launch the kernels (counted in ``launches``); CPU tensors
    run ``ops/sh.view_color``."""
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError(f"sh_color: positions must be (N, 3), not {tuple(positions.shape)}")
    if sh.dim() != 2 or sh.shape[0] != positions.shape[0]:
        raise ValueError(f"sh_color: sh must be (N, 3·(deg+1)²) with N = {positions.shape[0]}, "
                         f"not {tuple(sh.shape)}")
    if not _on_cuda(sh):
        return view_color(positions, sh, cam_position, degree)
    if positions.device != sh.device or cam_position.device != sh.device:
        raise ValueError("sh_color: positions, sh and the camera position must be on one device")
    if cam_position.numel() != 3:
        raise ValueError("sh_color: the camera position must hold 3 values")
    if cam_position.requires_grad and torch.is_grad_enabled():
        raise ValueError("sh_color: the kernel gives no gradient of the camera position")
    stored, degree = _degrees(sh, degree)
    f32 = torch.float32
    positions = positions.to(f32).contiguous()
    sh = sh.to(f32).contiguous()
    cam = cam_position.to(f32).contiguous()
    if torch.is_grad_enabled() and (positions.requires_grad or sh.requires_grad):
        return _ShColor.apply(positions, sh, cam, stored, degree)
    return _forward(positions, sh, cam, stored, degree)


#: Kernel launches made through ``sh_color`` in this process, forward and
#: backward.
sh_color.launches = 0
