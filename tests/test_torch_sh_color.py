"""The SH colour step (``ops/cuda/sh_color.py``) on the CPU, and the
float64 twin of its kernel's backward that the card test holds the kernel
to (tests/test_torch_sh_color_card.py).

The twin writes the backward of ``csrc/sh_color.cu`` in plain PyTorch:
the clamp's mask from the recomputed colour, the coefficient gradient as
one product of the masked cotangent and the basis, and the position
gradient from the basis's own derivatives through the direction's
normalisation. Here it is checked against autograd of the plain chain
(normalisation and ``eval_sh_columns``) in float64, at every stored and
evaluated degree, with colours clamped at both ends. On CPU tensors the
step runs the plain chain: no kernel launch, the projection's colour and
its gradients bit for bit those of the chain it ran before.

The module imports no JAX, so the card test can import its helpers where
JAX is not installed.
"""

import numpy as np
import pytest
import torch

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.ops.cuda import sh_color as shc
from gaussianrenderer_tpu_torch.ops.projection import preprocess_gaussians
from gaussianrenderer_tpu_torch.ops.sh import (SH_C0, SH_C1, SH_C2, SH_C3, eval_sh_columns,
                                               sqrt_f32, view_color)

CAM = (0.3, -0.2, 4.0)
#: (stored, evaluated) SH degrees the kernels are built for.
DEGREES = [(s, d) for s in range(4) for d in range(s + 1)]


def make_inputs(n: int, stored: int, seed: int, dtype=torch.float32, device="cpu"):
    """``n`` splats around the origin with coefficients of SH degree
    ``stored``, DC terms spread so that about a quarter of the colours
    clamp at 0 or 1, and a cotangent; (positions, sh, cam, g)."""
    rng = np.random.default_rng(seed)
    w = 3 * (stored + 1) ** 2
    pos = rng.normal(0.0, 1.5, (n, 3))
    sh = rng.normal(0.0, 0.3, (n, w))
    sh[:, :3] += rng.uniform(-2.5, 2.5, (n, 3))
    g = rng.normal(0.0, 1.0, (n, 3))

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    return t(pos), t(sh), t(np.array(CAM)), t(g)


def _basis(x, y, z, degree):
    """The basis terms and their (∂x, ∂y, ∂z), one list entry a term."""
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    terms = [(SH_C0 * one, (zero, zero, zero))]
    if degree > 0:
        terms += [(-SH_C1 * y, (zero, -SH_C1 * one, zero)),
                  (SH_C1 * z, (zero, zero, SH_C1 * one)),
                  (-SH_C1 * x, (-SH_C1 * one, zero, zero))]
    if degree > 1:
        c = SH_C2
        xx, yy, zz = x * x, y * y, z * z
        terms += [(c[0] * x * y, (c[0] * y, c[0] * x, zero)),
                  (c[1] * y * z, (zero, c[1] * z, c[1] * y)),
                  (c[2] * (2 * zz - xx - yy), (-2 * c[2] * x, -2 * c[2] * y, 4 * c[2] * z)),
                  (c[3] * x * z, (c[3] * z, zero, c[3] * x)),
                  (c[4] * (xx - yy), (2 * c[4] * x, -2 * c[4] * y, zero))]
    if degree > 2:
        c = SH_C3
        terms += [
            (c[0] * y * (3 * xx - yy), (6 * c[0] * x * y, 3 * c[0] * (xx - yy), zero)),
            (c[1] * x * y * z, (c[1] * y * z, c[1] * x * z, c[1] * x * y)),
            (c[2] * y * (4 * zz - xx - yy),
             (-2 * c[2] * x * y, c[2] * (4 * zz - xx - 3 * yy), 8 * c[2] * y * z)),
            (c[3] * z * (2 * zz - 3 * xx - 3 * yy),
             (-6 * c[3] * x * z, -6 * c[3] * y * z, c[3] * (6 * zz - 3 * xx - 3 * yy))),
            (c[4] * x * (4 * zz - xx - yy),
             (c[4] * (4 * zz - 3 * xx - yy), -2 * c[4] * x * y, 8 * c[4] * x * z)),
            (c[5] * z * (xx - yy), (2 * c[5] * x * z, -2 * c[5] * y * z, c[5] * (xx - yy))),
            (c[6] * x * (xx - 3 * yy), (3 * c[6] * (xx - yy), -6 * c[6] * x * y, zero)),
        ]
    b = torch.stack([t for t, _ in terms], dim=1)  # (N, K)
    db = torch.stack([torch.stack(d, dim=1) for _, d in terms], dim=1)  # (N, K, 3)
    return b, db


def twin_backward(pos, sh, cam, degree, g, mask=None):
    """The kernel's backward in plain PyTorch, in the inputs' dtype:
    ``(dsh, dpos, scale)``, ``scale`` (N,) each row's sum of the absolute
    terms of its position gradient (the size its rounding scales with).
    ``mask`` (N, 3), optional, is the clamp's mask to use in place of the
    one this computes (a float32 colour can clamp where the float64 one
    does not)."""
    n, w = sh.shape
    stored = int(round((w // 3) ** 0.5)) - 1
    degree = max(0, min(degree, stored))
    k = (degree + 1) ** 2
    d = pos - cam
    norm = torch.sqrt((d * d).sum(1))
    inv = torch.where(norm > 1e-8, 1.0 / norm, 0.0)
    u = d * inv[:, None]
    b, db = _basis(u[:, 0], u[:, 1], u[:, 2], degree)
    coeff = sh.reshape(n, -1, 3)[:, :k]  # (N, K, 3)
    v = (b[..., None] * coeff).sum(1) + 0.5
    gm = torch.where((v >= 0) & (v <= 1) if mask is None else mask, g, 0.0)
    dsh = torch.zeros_like(sh)
    dsh.view(n, -1, 3)[:, :k] = b[..., None] * gm[:, None, :]
    gb = (gm[:, None, :] * coeff).sum(-1)  # (N, K)
    gu = (gb[..., None] * db).sum(1)  # (N, 3)
    dpos = inv[:, None] * (gu - u * (gu * u).sum(1, keepdim=True))
    scale = inv * (gb.abs()[..., None] * db.abs()).sum((1, 2))
    return dsh, dpos, scale


def plain64(pos, sh, cam, degree):
    """The plain chain in the inputs' dtype (no float32 square root)."""
    d = pos - cam
    norm = torch.sqrt((d * d).sum(1))
    inv = torch.where(norm > 1e-8, 1.0 / norm, 0.0)
    u = d * inv[:, None]
    return eval_sh_columns(sh.T, u[:, 0], u[:, 1], u[:, 2], degree)


def clamp_mask(pos, sh, cam, degree):
    """(N, 3) the float32 plain chain's clamp mask: its colour before the
    clamp lies in [0, 1]."""
    pos_t = pos.T
    dx, dy, dz = pos_t[0] - cam[0], pos_t[1] - cam[1], pos_t[2] - cam[2]
    norm = sqrt_f32(dx * dx + dy * dy + dz * dz)
    inv_n = torch.where(norm > 1e-8, 1.0 / norm, 0.0)
    v = eval_sh_columns(sh.T, dx * inv_n, dy * inv_n, dz * inv_n, degree, clamp=False) + 0.5
    return (v >= 0) & (v <= 1)


@pytest.mark.parametrize("stored, degree", DEGREES)
def test_twin_matches_autograd_in_float64(stored, degree):
    pos, sh, cam, g = make_inputs(4000, stored, seed=10 * stored + degree, dtype=torch.float64)
    pos.requires_grad_(True)
    sh.requires_grad_(True)
    color = plain64(pos, sh, cam, degree)
    clamped = ((color == 0) | (color == 1)).float().mean()
    assert 0.1 < float(clamped) < 0.5  # the mask is exercised
    want_pos, want_sh = torch.autograd.grad(color, (pos, sh), g, allow_unused=True)
    dsh, dpos, scale = twin_backward(pos.detach(), sh.detach(), cam, degree, g)
    assert torch.allclose(dsh, want_sh, rtol=1e-13, atol=1e-15)
    if degree == 0:
        assert want_pos is None and not dpos.any()
    else:
        assert bool(((dpos - want_pos).abs() <= 1e-12 * scale[:, None] + 1e-300).all())


def test_twin_gives_no_position_gradient_at_the_camera():
    pos, sh, cam, g = make_inputs(4, 3, seed=1, dtype=torch.float64)
    pos[1] = cam
    dsh, dpos, _ = twin_backward(pos, sh, cam, 3, g)
    assert torch.equal(dpos[1], torch.zeros(3, dtype=torch.float64))
    assert torch.isfinite(dsh).all()


def _cpu_scene(n: int, seed: int):
    rng = np.random.default_rng(seed)
    f = torch.float32
    pos = torch.tensor(rng.normal(0.0, 1.0, (n, 3)), dtype=f)
    pos[5] = float("nan")
    leaves = [pos,
              torch.tensor(rng.normal(0.0, 0.5, (n, 48)), dtype=f),
              torch.tensor(rng.uniform(0.1, 0.9, n), dtype=f),
              torch.tensor(np.exp(rng.uniform(-4.0, -1.0, (n, 3))), dtype=f),
              torch.tensor(rng.normal(0.0, 1.0, (n, 4)), dtype=f)]
    leaves = [t.requires_grad_(True) for t in leaves]
    scene = gt.GaussianScene(positions=leaves[0], sh=leaves[1], opacity=leaves[2],
                             scales=leaves[3], quats=leaves[4])
    cam = gt.Camera()
    cam.set_position([0.3, -0.2, 4.0])
    cam.set_look_at([0.0, 0.0, 0.0])
    cam.update_camera_matrices()
    return scene, cam.params(3.0, device="cpu")


def _chain_before(scene, cam, degree):
    """The colour block ``preprocess_gaussians`` ran inline before it
    called ``sh_color``."""
    pos_t = scene.positions.T
    cpos = cam.position
    dx, dy, dz = pos_t[0] - cpos[0], pos_t[1] - cpos[1], pos_t[2] - cpos[2]
    norm = sqrt_f32(dx * dx + dy * dy + dz * dz)
    inv_n = torch.where(norm > 1e-8, 1.0 / norm, 0.0)
    return eval_sh_columns(scene.sh.T, dx * inv_n, dy * inv_n, dz * inv_n, degree)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_projection_on_cpu_keeps_the_plain_chain(degree):
    scene, cam = _cpu_scene(3000, seed=degree)
    before = shc.sh_color.launches
    proj = preprocess_gaussians(scene, cam, width=64, height=48, tile_w=16, tile_h=16,
                                tiles_x=4, tiles_y=3, sh_degree=degree, quantize_centers=False)
    assert shc.sh_color.launches == before
    chain = _chain_before(scene, cam, degree)
    valid = proj.valid
    assert 0 < int(valid.sum()) < valid.numel()
    assert torch.equal(proj.color[valid], chain[valid])
    g = torch.tensor(np.random.default_rng(7).normal(0.0, 1.0, (3000, 3)), dtype=torch.float32)
    got = torch.autograd.grad(proj.color, (scene.positions, scene.sh), g, allow_unused=True)
    want = torch.autograd.grad(chain, (scene.positions, scene.sh), g, allow_unused=True)
    for a, b in zip(got, want):
        if b is None:  # degree 0: no position gradient on either side
            assert a is None
            continue
        assert torch.equal(a, torch.where(valid[:, None], b, 0.0))


def test_sh_color_checks_its_arguments():
    pos, sh, cam, _ = make_inputs(5, 3, seed=0)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        shc.sh_color(pos[:, :2], sh, cam, 3)
    with pytest.raises(ValueError, match="sh must be"):
        shc.sh_color(pos, sh[:4], cam, 3)
    with pytest.raises(ValueError, match="device"):
        shc.sh_color(pos.to("meta"), sh.to("meta"), cam.to("meta"), 3)
    with pytest.raises(ValueError, match="3, 12, 27 or 48"):
        shc._degrees(sh[:, :6], 3)
    assert shc._degrees(sh, 7) == (3, 3) and shc._degrees(sh[:, :12], 3) == (1, 1)
    assert shc._degrees(sh[:, :27], -1) == (2, 0)
    assert torch.equal(shc.sh_color(pos, sh, cam, 2), view_color(pos, sh, cam, 2))
