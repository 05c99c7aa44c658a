"""The f32 compositors (``composite_tiles_xla``, ``composite_tiles_diff``)
and autograd through the differentiable one, held against the JAX
package's on the CPU.

Both sides composite the same sorted features (the port's, bit-equal to
the JAX package's: tests/test_torch_tiling.py). Gates: framebuffers,
alpha and expected-depth rows included, within 1e-5 of JAX (float
summation order); the gradient of a random linear loss through the
port's ``composite_tiles_diff`` against ``jax.grad`` of the JAX one, per
feature column, max |Δ| / max |JAX| ≤ 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops.compositing import (
    composite_tiles_diff as jax_diff,
    composite_tiles_xla as jax_xla,
)

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.ops.compositing import gather_sorted_features

from test_torch_common import both_cameras, both_scenes, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRAD_COLS = {"cx": 0, "cy": 1, "A": 2, "B": 3, "C": 4, "op": 5, "r": 6, "g": 7,
             "b": 8, "depth": 13}


def sorted_features(n, seed, h, w, scale_range=(0.05, 0.3), **cfg_kw):
    _, ps = both_scenes(n, seed=seed, scale_range=scale_range)
    cfg = gt.RenderConfig(height=h, width=w, **cfg_kw)
    _, pcam, _ = both_cameras(w, h)
    proj = gt.preprocess_gaussians(
        ps, pcam, width=w, height=h, tile_w=cfg.tile_w, tile_h=cfg.tile_h,
        tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, sh_degree=cfg.sh_degree,
        quantize_centers=False,
    )
    asg = gt.build_sorted_instances(proj, tiles_x=cfg.tiles_x, num_tiles=cfg.num_tiles,
                                    near=pcam.near, far=pcam.far)
    sf = gather_sorted_features(gt.build_features(proj), asg, cfg.chunk_size)
    return sf, asg, cfg


def geometry(cfg):
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
                tile_h=cfg.tile_h, width=cfg.width, height=cfg.height,
                chunk_size=cfg.chunk_size)


@pytest.mark.parametrize("size", [(150, 200), (96, 128)])
def test_framebuffers_match_jax(size):
    h, w = size
    kw = dict(num_tile_x=8, num_tile_y=12) if size == (96, 128) else {}
    sf, asg, cfg = sorted_features(1500, 7, h, w, **kw)
    geom = geometry(cfg)
    rows = dict(return_alpha=True, return_depth=True)
    jsf = jnp.asarray(sf.numpy())
    js, jc = jnp.asarray(asg.tile_start.numpy()), jnp.asarray(asg.tile_count.numpy())
    assert int(asg.tile_count.max()) <= cfg.diff_max_chunks * cfg.chunk_size
    p_xla = gt.composite_tiles_xla(sf, asg.tile_start, asg.tile_count, **geom, **rows)
    j_xla = np.asarray(jax.jit(functools.partial(jax_xla, **geom, **rows))(jsf, js, jc))
    p_diff = gt.composite_tiles_diff(sf, asg.tile_start, asg.tile_count, **geom,
                                     max_chunks=cfg.diff_max_chunks, **rows)
    j_diff = np.asarray(jax.jit(functools.partial(
        jax_diff, **geom, max_chunks=cfg.diff_max_chunks, **rows))(jsf, js, jc))
    assert p_xla.shape == (5, h, w) == j_xla.shape
    assert float(p_xla[3].max()) > 0.5  # the frame is covered
    for got, want in ((p_xla, j_xla), (p_diff, j_diff)):
        rgb_a = np.abs(got[:4].numpy() - want[:4]).max()
        depth = np.abs(got[4].numpy() - want[4]).max() / np.abs(want[4]).max()
        assert rgb_a <= 1e-5 and depth <= 1e-5, (rgb_a, depth)


def test_diff_autograd_matches_jax_grad():
    sf, asg, cfg = sorted_features(800, 3, 128, 160, scale_range=(0.05, 0.25))
    geom = geometry(cfg)
    rows = dict(return_alpha=True, return_depth=True, max_chunks=cfg.diff_max_chunks)
    gw = np.random.default_rng(0).normal(size=(5, cfg.height, cfg.width)).astype(
        np.float32)
    x = sf.clone().requires_grad_(True)
    fb = gt.composite_tiles_diff(x, asg.tile_start, asg.tile_count, **geom, **rows)
    (fb * torch.from_numpy(gw)).sum().backward()
    got = x.grad.numpy()

    js, jc = jnp.asarray(asg.tile_start.numpy()), jnp.asarray(asg.tile_count.numpy())
    want = np.asarray(jax.jit(jax.grad(lambda f: jnp.sum(
        jax_diff(f, js, jc, **geom, **rows) * gw)))(jnp.asarray(sf.numpy())))
    for name, col in GRAD_COLS.items():
        scale = np.abs(want[:, col]).max()
        assert scale > 0, name
        rel = np.abs(got[:, col] - want[:, col]).max() / scale
        assert rel <= 1e-4, (name, rel)
    # The AABB rows carry no gradient on either side.
    assert np.abs(got[:, 9:13]).max() == 0.0 and np.abs(want[:, 9:13]).max() == 0.0
