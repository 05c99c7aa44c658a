"""``render_frame`` on the f32 tile-sort path (``compositor="xla"``,
``"diff"`` with the training kernels and with the scan compositor, and
``"packed"`` on a grid the packed records cannot describe), against the
JAX package's jitted ``render_frame`` on the CPU.

Gates: ``num_culled`` and ``num_instances`` equal, ``overflow`` False;
every row within 1e-3 of the jitted JAX frame and ≥ 60 dB, the depth row
after dividing by its largest value (the jitted projection contracts
products into fused multiply-adds, which can move an alpha across the
1e-3 blend threshold: the JAX package's own jitted and op-by-op frames
differ by 1.6e-4 on the packed-fallback case). Against the JAX frame run
op by op, the xla-compositor cases agree within 1e-5 (float summation
order). Each port frame is also held against the other compositor routes
where they must agree: the training kernels against the scan compositor
within the 2e-3 stop envelope.
"""

import dataclasses

import jax
import numpy as np
import pytest

from gaussianrenderer_tpu.render import _render_impl as jax_render_impl
from gaussianrenderer_tpu.render import render_frame as jax_render

import gaussianrenderer_tpu_torch as gt

from test_torch_common import both_cameras, both_configs, both_scenes, np_tree, psnr_np, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = {
    "xla": dict(n=1500, seed=0, cfg=dict(height=128, width=160, compositor="xla",
                                         output_alpha=True)),
    # 25×25-pixel tiles: not a multiple of 128 pixels, so "packed" takes
    # the xla compositor, as in the JAX package.
    "packed_fallback": dict(n=1200, seed=1, cfg=dict(
        height=100, width=100, num_tile_x=4, num_tile_y=4,
        background=(0.2, 0.5, 1.0), output_alpha=True)),
    "diff_scan": dict(n=1000, seed=2, cfg=dict(height=128, width=160,
                                               compositor="diff", diff_kernel=False,
                                               output_alpha=True)),
    # The training kernels on both sides (the JAX Pallas kernels run
    # interpreted, so the frame is small).
    "diff_kernel": dict(n=400, seed=3, cfg=dict(height=64, width=96,
                                                compositor="diff")),
    # A depth row is served by the scan compositor even with diff_kernel.
    "diff_depth": dict(n=800, seed=4, cfg=dict(height=96, width=128,
                                               compositor="diff", output_depth=True,
                                               output_alpha=True)),
}


def render_both(case):
    spec = CASES[case]
    js, ps = both_scenes(spec["n"], seed=spec["seed"], scale_range=(0.03, 0.3))
    jcfg, pcfg = both_configs(quantize_centers=False, **spec["cfg"])
    jcam, pcam, _ = both_cameras(pcfg.width, pcfg.height)
    jfb, jst = jax_render(js, jcam, jcfg)
    pfb, pst = gt.render_frame(ps, pcam, pcfg)
    jfb_ops = None
    if jcfg.compositor != "diff":
        with jax.disable_jit():
            jfb_ops = np.asarray(jax_render_impl(js, jcam, jcfg)[0])
    return np.asarray(jfb), jfb_ops, np_tree(jst), pfb, pst, ps, pcam, pcfg


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_sort_frame_matches_jax(case):
    jfb, jfb_ops, jst, pfb, pst, ps, pcam, cfg = render_both(case)
    assert pfb.shape == jfb.shape
    assert int(pst.num_culled) == int(jst.num_culled)
    assert int(pst.num_instances) == int(jst.num_instances) > 0
    assert not bool(jst.overflow) and not bool(pst.overflow)
    got = pfb.numpy()
    n_img = 3 + int(cfg.output_alpha)
    assert np.abs(got[:n_img] - jfb[:n_img]).max() <= 1e-3
    assert psnr_np(got[:n_img], jfb[:n_img]) >= 60.0
    if jfb_ops is not None:
        assert np.abs(got - jfb_ops).max() <= 1e-5
    if cfg.output_depth:
        assert got.shape[0] == 5
        scale = np.abs(jfb[-1]).max()
        assert scale > 0 and np.abs(got[-1] - jfb[-1]).max() / scale <= 1e-3
    if case == "diff_kernel":
        scan, _ = gt.render_frame(ps, pcam, dataclasses.replace(cfg, diff_kernel=False))
        assert float((pfb - scan).abs().max()) < 2e-3
    if case == "xla":
        diff, _ = gt.render_frame(ps, pcam, dataclasses.replace(cfg, compositor="diff"))
        assert float((pfb - diff).abs().max()) < 2e-3
