"""The f32 tile-sort path's front half: ``build_sorted_instances``,
``build_features`` and the feature gathers, held against the JAX package
on the CPU.

Gates: the sorted instance list (``gaussian_id``, ``tile_id``), the
per-tile ranges and the total are bit-equal to the JAX function's first
``total_instances`` slots (the emission order and the stable sort's tie
rule are the same, so no tie-order allowance is needed); ``overflow`` is
False on both sides. Feature rows are equal, and the gathered rows too.
The JAX projection runs op by op, which the projection tests hold
bit-equal to the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops.compositing import (
    build_features as jax_build_features,
    gather_sorted_features as jax_gather,
)
from gaussianrenderer_tpu.ops.projection import preprocess_gaussians as jax_preprocess
from gaussianrenderer_tpu.ops.tiling import build_sorted_instances as jax_build_sorted

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.ops.compositing import (
    gather_sorted_features,
    gather_sorted_features_seg,
)

from test_torch_common import both_cameras, both_configs, both_scenes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = {
    # A frame whose size is not a multiple of 32: the last tile column
    # and row reach past the image.
    "ragged_150x200": dict(scene=dict(n=1500, seed=1, scale_range=(0.02, 0.3)),
                           cfg=dict(height=150, width=200)),
    # Splats behind the camera and off screen (extent 9 around a camera
    # 5.5 from the origin), 16×8 tiles.
    "behind_tiles16x8": dict(scene=dict(n=1200, seed=4, extent=9.0),
                             cfg=dict(height=96, width=128, num_tile_x=8,
                                      num_tile_y=12)),
    "wide_128x160": dict(scene=dict(n=600, seed=2, scale_range=(0.1, 0.6)),
                         cfg=dict(height=128, width=160)),
}


def project_both(case):
    spec = CASES[case]
    sc = dict(spec["scene"])
    js, ps = both_scenes(sc.pop("n"), **sc)
    jcfg, pcfg = both_configs(**spec["cfg"])
    jcam, pcam, _ = both_cameras(pcfg.width, pcfg.height)
    kw = dict(width=pcfg.width, height=pcfg.height, tile_w=pcfg.tile_w,
              tile_h=pcfg.tile_h, tiles_x=pcfg.tiles_x, tiles_y=pcfg.tiles_y,
              sh_degree=pcfg.sh_degree, quantize_centers=False)
    jproj = jax_preprocess(js, jcam, **kw)
    pproj = gt.preprocess_gaussians(ps, pcam, **kw)
    return jproj, pproj, jcfg, pcfg, jcam, pcam


@pytest.mark.parametrize("case", sorted(CASES))
def test_sorted_instances_bit_equal(case):
    jproj, pproj, jcfg, pcfg, jcam, pcam = project_both(case)
    n = int(pproj.valid.shape[0])
    np.testing.assert_array_equal(np.asarray(jproj.valid), pproj.valid.numpy())
    ja = jax_build_sorted(
        jproj, tiles_x=jcfg.tiles_x, num_tiles=jcfg.num_tiles,
        capacity=jcfg.instance_capacity(n) * 4, depth_scale=jcfg.depth_scale,
        near=jcam.near, far=jcam.far,
    )
    pa = gt.build_sorted_instances(
        pproj, tiles_x=pcfg.tiles_x, num_tiles=pcfg.num_tiles,
        capacity=pcfg.instance_capacity(n), near=pcam.near, far=pcam.far,
    )
    total = int(ja.total_instances)
    assert not bool(ja.overflow) and not bool(pa.overflow)
    assert total > 500 and int(pa.total_instances) == total
    assert pa.gaussian_id.shape == (total,) and pa.gaussian_id.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ja.gaussian_id)[:total],
                                  pa.gaussian_id.numpy())
    np.testing.assert_array_equal(np.asarray(ja.tile_id)[:total], pa.tile_id.numpy())
    np.testing.assert_array_equal(np.asarray(ja.tile_start), pa.tile_start.numpy())
    np.testing.assert_array_equal(np.asarray(ja.tile_count), pa.tile_count.numpy())
    if case == "behind_tiles16x8":
        depth = pproj.depth.numpy()
        assert (depth < 0).sum() > 100 and int(pproj.valid.sum()) < n // 2

    # Feature rows and the gathers (plain and segment-sum), equal.
    jf = np.asarray(jax_build_features(jproj))
    pf = gt.build_features(pproj)
    np.testing.assert_array_equal(jf, pf.numpy())
    k = pcfg.chunk_size
    jg = np.asarray(jax_gather(jnp.asarray(jf), ja, k))
    pg = gather_sorted_features(pf, pa, k)
    np.testing.assert_array_equal(jg[:total], pg[:total].numpy())
    assert pg.shape == (total + k, 16) and float(pg[total:].abs().max()) == 0.0
    np.testing.assert_array_equal(pg.numpy(),
                                  gather_sorted_features_seg(pf, pa, k).numpy())


def test_seg_gather_backward_is_index_add_and_jax_transpose():
    """The segment-sum backward equals index_add_ over gaussian_id, and
    the JAX package's sort + cumsum transpose (relative 1e-5: that one
    differences f32 prefix sums)."""
    from gaussianrenderer_tpu.ops.compositing import (
        gather_sorted_features_seg as jax_gather_seg,
    )

    jproj, pproj, jcfg, pcfg, jcam, pcam = project_both("wide_128x160")
    n = int(pproj.valid.shape[0])
    cap = jcfg.instance_capacity(n) * 4
    ja = jax_build_sorted(jproj, tiles_x=jcfg.tiles_x, num_tiles=jcfg.num_tiles,
                          capacity=cap, near=jcam.near, far=jcam.far)
    pa = gt.build_sorted_instances(pproj, tiles_x=pcfg.tiles_x,
                                   num_tiles=pcfg.num_tiles, near=pcam.near,
                                   far=pcam.far)
    total = int(pa.total_instances)
    k = pcfg.chunk_size
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    cot = rng.normal(size=(total + k, 16)).astype(np.float32)

    f = torch.from_numpy(feats).requires_grad_(True)
    gathered = gather_sorted_features_seg(f, pa, k)
    (gathered * torch.from_numpy(cot)).sum().backward()
    want = torch.zeros(n, 16).index_add_(
        0, pa.gaussian_id.to(torch.int64), torch.from_numpy(cot[:total])
    )
    np.testing.assert_allclose(f.grad.numpy(), want.numpy(), rtol=0, atol=0)

    jcot = np.zeros((cap + k, 16), np.float32)
    jcot[:total] = cot[:total]
    jgrad = jax.grad(lambda x: jnp.sum(
        jax_gather_seg(x, ja, k, jproj, cap, jcfg.num_tiles) * jcot
    ))(jnp.asarray(feats))
    scale = np.abs(want.numpy()).max()
    assert np.abs(np.asarray(jgrad) - want.numpy()).max() <= 1e-5 * scale
