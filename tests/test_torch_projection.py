"""SH color and per-Gaussian projection of the port against the JAX package.

The cases are split over this file and test_torch_projection_more.py
to keep each file's run short. Tolerances: the integer outputs (``valid``, ``tile_min``, ``tile_max``)
and the integer-valued pixel fields (``aabb_px`` after floor/ceil,
``center_px`` after round) must be bit-exact; the float fields may differ
by float32 evaluation order (XLA fuses and rewrites, e.g. 1/sqrt into
rsqrt), so they are held at rtol 1e-5, atol 1e-6.
"""

import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops.projection import preprocess_gaussians
from gaussianrenderer_tpu.ops.projection import quat_to_rotmat as jax_q2r
from gaussianrenderer_tpu.ops.projection import slice_spacetime as jax_slice
from gaussianrenderer_tpu.ops.sh import eval_sh_columns as jax_sh
from gaussianrenderer_tpu.scene.gaussians import GaussianScene as JaxScene

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.convert import to_torch_scene
from gaussianrenderer_tpu_torch.ops.projection import quat_to_rotmat

from test_torch_common import both_cameras, both_configs, both_scenes, needle_scene

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-6
EXACT_FIELDS = ("valid", "tile_min", "tile_max", "aabb_px", "center_px")

#: The JAX function runs op by op, each op its own XLA computation. Under
#: jit, XLA contracts multiply-adds into FMAs, which moves the conic of a
#: near-degenerate splat by up to ~0.2%; the whole-frame tests cover the
#: jitted path through its PSNR.
jax_pre = preprocess_gaussians


@pytest.mark.parametrize("stored,degree", [(0, 0), (1, 1), (2, 2), (3, 3), (3, 1), (1, 3)])
def test_eval_sh_columns_matches(stored, degree):
    rng = np.random.default_rng(stored * 10 + degree)
    n = 777
    sh_t = rng.normal(0, 0.5, (3 * (stored + 1) ** 2, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    want = np.asarray(jax_sh(sh_t, d[0], d[1], d[2], degree))
    got = gt.eval_sh_columns(
        torch.from_numpy(sh_t), *(torch.from_numpy(d[i]) for i in range(3)), degree
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    raw = gt.eval_sh_columns(
        torch.from_numpy(sh_t), *(torch.from_numpy(d[i]) for i in range(3)),
        degree, clamp=False,
    ).numpy()
    np.testing.assert_allclose(
        raw, np.asarray(jax_sh(sh_t, d[0], d[1], d[2], degree, clamp=False)),
        rtol=FLOAT_RTOL, atol=FLOAT_ATOL,
    )


def _nonfinite_scene():
    js, _ = both_scenes(600, seed=11)
    pos = np.asarray(js.positions).copy()
    sc = np.asarray(js.scales).copy()
    q = np.asarray(js.quats).copy()
    pos[0] = np.nan
    pos[1, 2] = np.inf
    sc[2] = np.inf
    sc[3] = 0.0
    q[4] = 0.0
    pos[5] = [0.5, -0.4, 5.5]  # at the camera position
    js = JaxScene(pos, np.asarray(js.sh), np.asarray(js.opacity), sc, q)
    return js, to_torch_scene(js, device="cpu")


def _giant_scene():
    js, _ = both_scenes(400, seed=12, extent=6.0, scale_range=(0.5, 3.0))
    return js, to_torch_scene(
        JaxScene(*(np.asarray(x) for x in js[:5])), device="cpu"
    )


_CASES = {
    "default": lambda: (both_scenes(2000, seed=0), dict(height=128, width=160), {}),
    "wide": lambda: (both_scenes(1500, seed=1, scale_range=(0.05, 0.5)),
                     dict(height=150, width=200), {}),
    "needles": lambda: (needle_scene(), dict(height=120, width=176), {}),
    "nonfinite": lambda: (_nonfinite_scene(), dict(height=128, width=160), {}),
    "giant": lambda: (_giant_scene(), dict(height=128, width=160), {}),
    "ewa": lambda: (both_scenes(1200, seed=5, scale_range=(0.004, 0.08)),
                    dict(height=128, width=160, ewa_dilation=0.3,
                         ewa_compensate=True), {}),
    "tiles16": lambda: (both_scenes(1000, seed=6),
                        dict(height=96, width=128, num_tile_x=8, num_tile_y=6), {}),
    "k_sigma_small": lambda: (both_scenes(1000, seed=7), dict(height=128, width=160),
                              dict(k_sigma=0.5)),
    "k_sigma_big": lambda: (both_scenes(1000, seed=8), dict(height=128, width=160),
                            dict(k_sigma=8.0)),
    "unquantized": lambda: (both_scenes(1000, seed=9),
                            dict(height=128, width=160, quantize_centers=False), {}),
    "deg3": lambda: (both_scenes(800, seed=10, sh_degree=3),
                     dict(height=128, width=160, sh_degree=3), {}),
    "portrait_near": lambda: (both_scenes(1500, seed=13), dict(height=200, width=96),
                              dict(pos=(0.3, 0.2, 2.2), fov=75.0, near=0.5)),
}


def _project_both(case):
    (js, ps), cfg_kw, cam_kw = _CASES[case]()
    jcfg, pcfg = both_configs(**cfg_kw)
    k_sigma = cam_kw.pop("k_sigma", 3.0)
    jcam, pcam, _ = both_cameras(pcfg.width, pcfg.height, k_sigma=k_sigma, **cam_kw)
    geo = dict(width=pcfg.width, height=pcfg.height, tile_w=pcfg.tile_w,
               tile_h=pcfg.tile_h, tiles_x=pcfg.tiles_x, tiles_y=pcfg.tiles_y,
               sh_degree=pcfg.sh_degree, quantize_centers=pcfg.quantize_centers,
               ewa_dilation=pcfg.ewa_dilation, ewa_compensate=pcfg.ewa_compensate)
    return jax_pre(js, jcam, **geo), gt.preprocess_gaussians(ps, pcam, **geo)


def assert_projected_match(jp, pp):
    for f in jp._fields:
        a, b = np.asarray(getattr(jp, f)), getattr(pp, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f in EXACT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=FLOAT_RTOL, atol=FLOAT_ATOL, err_msg=f)


@pytest.mark.parametrize(
    "case", ["default", "wide", "needles", "nonfinite", "giant", "ewa"]
)
def test_preprocess_matches(case):
    jp, pp = _project_both(case)
    assert int(pp.valid.sum()) > 0
    assert_projected_match(jp, pp)


def test_slice_spacetime_then_project_matches():
    js, ps = both_scenes(900, seed=9, spacetime=True)
    jcfg, pcfg = both_configs(height=128, width=160)
    jcam, pcam, _ = both_cameras(160, 128)
    for tv in (None, 0.0, 0.37, 1.2):
        js2, jx = jax_slice(js, tv)
        ps2, px = gt.slice_spacetime(ps, tv)
        if tv is None:
            assert jx is None and px is None and ps2 is ps
            continue
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
        np.testing.assert_allclose(
            ps2.positions.numpy(), np.asarray(js2.positions),
            rtol=FLOAT_RTOL, atol=FLOAT_ATOL,
        )
        geo = dict(width=160, height=128, tile_w=32, tile_h=32, tiles_x=5, tiles_y=4)
        jp = jax_pre(js2, jcam, extra_opacity_scale=jx, **geo)
        pp = gt.preprocess_gaussians(ps2, pcam, extra_opacity_scale=px, **geo)
        assert_projected_match(jp, pp)
    # (N, 2) time params: temporal opacity only, positions untouched.
    ps_t2 = ps._replace(time_params=ps.time_params[:, :2])
    moved, op = gt.slice_spacetime(ps_t2, 0.5)
    torch.testing.assert_close(moved.positions, ps.positions, rtol=0, atol=0)
    assert op.shape == (900,)


def test_quat_to_rotmat_matches():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(500, 4)).astype(np.float32)
    np.testing.assert_allclose(
        quat_to_rotmat(torch.from_numpy(q)).numpy(), np.asarray(jax_q2r(q)),
        rtol=FLOAT_RTOL, atol=FLOAT_ATOL,
    )
