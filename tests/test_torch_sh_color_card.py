"""The SH colour kernels (``csrc/sh_color.cu``) against the plain chain
(``ops/sh.view_color`` under autograd) on a CUDA card; skipped where there
is none. No JAX here, so the file runs on a machine with a card:

    python -m pytest tests/test_torch_sh_color_card.py -q -n 0

Gates, at every stored SH degree 0–3 and every evaluated degree up to it,
for N of 0, 1, 31, 33 and 100,003: the colour and the coefficient gradient
``torch.equal`` to the plain chain's on the card; the position gradient
within ``DPOS_TOL`` of each row's scale (its absolute terms' sum, from the
float64 twin) of the float64 twin (tests/test_torch_sh_color.py) and of
the plain chain's; two backward calls bit-equal; one forward and one
backward launch a call. Through ``preprocess_gaussians``: the coefficient
and position gradients of NaN splats and culled splats exactly zero, the
valid rows' coefficient gradient equal to the plain chain's, and the
``no_grad`` forward that ``render.py`` runs equal to the plain colour.
"""

import numpy as np
import pytest
import torch

from test_torch_sh_color import (DEGREES, _cpu_scene, clamp_mask, make_inputs,
                                 twin_backward)

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.ops.cuda import sh_color as shc
from gaussianrenderer_tpu_torch.ops.projection import preprocess_gaussians
from gaussianrenderer_tpu_torch.ops.sh import view_color

#: The position gradient against the float64 twin, per row, over the row's
#: sum of absolute terms: a float32 sum of up to ~50 terms in another
#: order. The plain chain reads at most 2.3e-6 of it (CPU, N = 100,003,
#: four seeds at every degree).
DPOS_TOL = 2e-5
SIZES = [0, 1, 31, 33, 100_003]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run this file on the H100")
    return torch.device("cuda")


def _grads(fn, pos, sh, cam, degree, g):
    p = pos.clone().requires_grad_(True)
    q = sh.clone().requires_grad_(True)
    color = fn(p, q, cam, degree)
    if color.numel() == 0:
        return color.detach(), torch.zeros_like(pos), torch.zeros_like(sh)
    gp, gq = torch.autograd.grad(color, (p, q), g, allow_unused=True)
    return color.detach(), torch.zeros_like(pos) if gp is None else gp, gq


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("stored, degree", DEGREES)
def test_kernel_matches_plain_on_cuda(stored, degree, n):
    dev = _cuda()
    pos, sh, cam, g = make_inputs(n, stored, seed=1000 + 10 * stored + degree, device=dev)
    before = shc.sh_color.launches
    color, dpos, dsh = _grads(shc.sh_color, pos, sh, cam, degree, g)
    torch.cuda.synchronize()
    assert shc.sh_color.launches - before == (2 if n else 0)
    want_color, want_dpos, want_dsh = _grads(view_color, pos, sh, cam, degree, g)
    assert torch.equal(color, want_color)
    assert torch.equal(dsh, want_dsh)
    if n == 0:
        return
    mask = clamp_mask(pos, sh, cam, degree)
    _, twin, scale = twin_backward(pos.double(), sh.double(), cam.double(), degree,
                                   g.double(), mask=mask)
    bound = DPOS_TOL * scale[:, None]
    assert bool(((dpos.double() - twin).abs() <= bound).all())
    assert bool(((dpos.double() - want_dpos.double()).abs() <= 2 * bound).all())
    # Again: the same bits.
    _, dpos2, dsh2 = _grads(shc.sh_color, pos, sh, cam, degree, g)
    assert torch.equal(dpos, dpos2) and torch.equal(dsh, dsh2)


def test_projection_zeroes_invalid_rows_on_cuda():
    """NaN and culled splats get exactly zero gradients through the
    projection on the card; valid rows' coefficient gradient is the plain
    chain's; the no-grad forward is the plain colour."""
    dev = _cuda()
    scene, cam = _cpu_scene(20_000, seed=3)
    scene = gt.GaussianScene(*(None if t is None else t.detach().to(dev).requires_grad_(True)
                               for t in scene))
    cam = gt.CameraParams(*(t.to(dev) for t in cam))
    kw = dict(width=64, height=48, tile_w=16, tile_h=16, tiles_x=4, tiles_y=3, sh_degree=3,
              quantize_centers=False)
    before = shc.sh_color.launches
    proj = preprocess_gaussians(scene, cam, **kw)
    g = torch.tensor(np.random.default_rng(5).normal(0.0, 1.0, (20_000, 3)),
                     dtype=torch.float32, device=dev)
    dpos, dsh = torch.autograd.grad(proj.color, (scene.positions, scene.sh), g)
    torch.cuda.synchronize()
    assert shc.sh_color.launches - before == 2
    valid = proj.valid
    assert not bool(valid[5]) and 0 < int(valid.sum()) < valid.numel()
    assert torch.equal(dsh[~valid], torch.zeros_like(dsh[~valid]))
    assert torch.equal(dpos[~valid], torch.zeros_like(dpos[~valid]))
    _, _, want_dsh = _grads(view_color, scene.positions.detach(), scene.sh.detach(),
                            cam.position, 3, g)
    assert torch.equal(dsh[valid], want_dsh[valid])
    with torch.no_grad():
        before = shc.sh_color.launches
        frame = preprocess_gaussians(scene, cam, **kw)
        assert shc.sh_color.launches - before == 1
    plain = view_color(scene.positions.detach(), scene.sh.detach(), cam.position, 3)
    assert torch.equal(frame.color[valid], plain[valid])
