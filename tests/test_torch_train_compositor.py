"""The training compositor (``composite_tiles_train``: the forward and the
hand-written backward, plain PyTorch versions on the CPU) against the JAX
package's Pallas kernels and against autograd through the port's own
``composite_tiles_diff``.

Gates: the plain forward within 1e-5 of the JAX kernels (run
interpreted, on one small frame: float summation order); within 2e-3 of
``composite_tiles_diff`` (the K-aligned chunk windows move where the
chunk-end freeze lands, inside the 1e-3 stop envelope); the plain
backward within max |Δ| / max |autograd| ≤ 1e-4 per feature column of
autograd through ``composite_tiles_diff`` on the JAX package's two
gradient cases (tests/test_train_kernel.py: 800 splats at 128×160, and a
heavy-overdraw 96×96 frame with over 20 chunks in a tile); feature
columns 9–15 and lanes past the last tile's range exactly 0. The CUDA
kernels against the plain versions run on the card (chip_smoke.py); their
test here skips without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.ops.compositing import gather_sorted_features
from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt
from gaussianrenderer_tpu_torch.ops.tile_train import train_kernel_compatible

from test_torch_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRAD_COLS = {"cx": 0, "cy": 1, "A": 2, "B": 3, "C": 4, "op": 5, "r": 6, "g": 7,
             "b": 8}


def camera(aspect, pos=(0.0, 0.0, 5.0), fov=60.0):
    cam = gt.Camera()
    cam.set_position(list(pos))
    cam.set_look_at([0.0, 0.0, 0.0])
    cam.set_fov_y(fov)
    cam.set_aspect_ratio(aspect)
    cam.set_clipping_planes(0.2, 100.0)
    cam.update_camera_matrices()
    return cam


def pipeline(scene, cam, cfg):
    """Sorted features and ranges of the training path (continuous
    centers), the port's counterpart of test_train_kernel._pipeline."""
    camp = cam.params(3.0, device="cpu")
    proj = gt.preprocess_gaussians(
        scene, camp, width=cfg.width, height=cfg.height, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        sh_degree=cfg.sh_degree, quantize_centers=False,
    )
    asg = gt.build_sorted_instances(proj, tiles_x=cfg.tiles_x, num_tiles=cfg.num_tiles,
                                    near=camp.near, far=camp.far)
    return gather_sorted_features(gt.build_features(proj), asg, cfg.chunk_size), asg


def normal_case():
    scene = gt.make_random_scene(800, seed=3, scale_range=(0.05, 0.25), device="cpu")
    cfg = gt.RenderConfig(height=128, width=160, compositor="diff")
    return pipeline(scene, camera(160 / 128), cfg) + (cfg,)


def heavy_case():
    scene = gt.make_random_scene(4000, seed=11, extent=0.8, scale_range=(0.2, 0.6),
                                 device="cpu")
    scene = scene._replace(opacity=torch.clamp(scene.opacity * 4.0, 0.0, 1.0))
    cfg = gt.RenderConfig(height=96, width=96, compositor="diff", diff_max_chunks=64)
    sf, asg = pipeline(scene, camera(1.0, pos=(0, 0, 2.5), fov=70.0), cfg)
    assert int(asg.tile_count.max()) > 20 * cfg.chunk_size
    return sf, asg, cfg


def geometry(cfg):
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
                tile_h=cfg.tile_h, width=cfg.width, height=cfg.height,
                chunk_size=cfg.chunk_size)


def both_grads(sf, asg, cfg, seed):
    gw = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(4, cfg.height, cfg.width)).astype(np.float32))
    out = []
    for fn in (gt.composite_tiles_diff, gt.composite_tiles_train):
        x = sf.clone().requires_grad_(True)
        kw = dict(max_chunks=cfg.diff_max_chunks) if fn is gt.composite_tiles_diff else {}
        fb = fn(x, asg.tile_start, asg.tile_count, return_alpha=True, **geometry(cfg),
                **kw)
        (fb * gw).sum().backward()
        out.append((fb.detach(), x.grad.numpy()))
    return out


@pytest.mark.parametrize("case", ["normal", "heavy_overdraw"])
def test_plain_backward_matches_autograd(case):
    sf, asg, cfg = normal_case() if case == "normal" else heavy_case()
    assert train_kernel_compatible(cfg.tile_w, cfg.tile_h)
    (fb_diff, g_diff), (fb_train, g_train) = both_grads(sf, asg, cfg, seed=1)
    assert float((fb_diff - fb_train).abs().max()) < 2e-3
    for name, col in GRAD_COLS.items():
        scale = np.abs(g_diff[:, col]).max()
        assert scale > 0, name
        rel = np.abs(g_diff[:, col] - g_train[:, col]).max() / scale
        assert rel <= 1e-4, (name, rel)
    # Columns 9–15 carry no gradient; lanes past the last tile's range
    # (the pad chunk) are never written.
    assert np.abs(g_train[:, 9:]).max() == 0.0
    end = int(asg.tile_start[-1] + asg.tile_count[-1])
    assert np.abs(g_train[end:]).max() == 0.0


def test_plain_forward_matches_jax_kernel_and_scan():
    """The plain forward against the JAX Pallas forward (interpreted) on a
    small frame, and against the port's scan compositor."""
    from gaussianrenderer_tpu.ops.pallas.tile_train import (
        composite_tiles_train as jax_train,
    )

    scene = gt.make_random_scene(300, seed=5, scale_range=(0.05, 0.3), device="cpu")
    cfg = gt.RenderConfig(height=64, width=96, compositor="diff")
    sf, asg = pipeline(scene, camera(96 / 64), cfg)
    geom = geometry(cfg)
    got = gt.composite_tiles_train(sf, asg.tile_start, asg.tile_count,
                                   return_alpha=True, **geom)
    want = np.asarray(jax_train(
        jnp.asarray(sf.numpy()), jnp.asarray(asg.tile_start.numpy()),
        jnp.asarray(asg.tile_count.numpy()), return_alpha=True, **geom))
    assert got.shape == (4, 64, 96) and float(got[3].max()) > 0.5
    assert np.abs(got.numpy() - want).max() <= 1e-5
    scan = gt.composite_tiles_diff(sf, asg.tile_start, asg.tile_count,
                                   return_alpha=True, **geom)
    assert float((got - scan).abs().max()) < 2e-3


def test_stats_checkpoints_and_chunk_offsets():
    """The forward's stats rows and checkpoints: each tile's first
    checkpoint is T = 1, its chunk count is i_end ≤ its chunk windows, and
    the offsets are the exclusive cumsum of the windows."""
    sf, asg, cfg = heavy_case()
    k = cfg.chunk_size
    off, n_chk = tt.chunk_offsets(asg.tile_start, asg.tile_count, k)
    start = asg.tile_start.to(torch.int64)
    windows = (start + asg.tile_count - start // k * k + k - 1) // k
    assert n_chk == int(windows.sum())
    assert torch.equal(off.to(torch.int64), torch.cumsum(windows, 0) - windows)
    kw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
              tile_h=cfg.tile_h, chunk=k)
    stats, chk = tt.train_forward(sf, asg.tile_start, asg.tile_count, off, n_chk, **kw)
    p = cfg.tile_w * cfg.tile_h
    st = stats.reshape(tt.STATS_ROWS, cfg.num_tiles, p)
    i_end = st[4, :, 0].to(torch.int64)
    assert torch.all(st[4] == st[4, :, :1]) and torch.all(i_end <= windows)
    assert bool((i_end < windows).any())  # heavy overdraw exits early
    assert torch.all(chk[off.to(torch.int64)[i_end > 0]] == 1.0)
    assert float(st[5:].abs().max()) == 0.0
    # A tile's carry only falls: every walked checkpoint ≥ T_final.
    for t in range(cfg.num_tiles):
        rows = chk[int(off[t]):int(off[t]) + int(i_end[t])]
        assert torch.all(rows >= st[3, t][None, :])


def test_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    for sf, asg, cfg in (normal_case(), heavy_case()):
        dev = torch.device("cuda")
        kw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
                  tile_h=cfg.tile_h, chunk=cfg.chunk_size)
        args = [t.to(dev) for t in (sf, asg.tile_start, asg.tile_count)]
        off, n_chk = tt.chunk_offsets(args[1], args[2], cfg.chunk_size)
        stats_k, chk_k = tt.train_forward(*args, off, n_chk, **kw)
        stats_p, chk_p = tt.train_forward_plain(*args, off, n_chk, **kw)
        assert float((stats_k - stats_p).abs().max()) <= 1e-4
        # Checkpoints of every walked chunk (rows past a tile's exit are
        # left unwritten by the kernel).
        i_end = stats_p.reshape(tt.STATS_ROWS, cfg.num_tiles, -1)[4, :, 0].to(torch.int64)
        for t in torch.nonzero(i_end).flatten().tolist():
            rows = slice(int(off[t]), int(off[t]) + int(i_end[t]))
            assert float((chk_k[rows] - chk_p[rows]).abs().max()) <= 1e-4
        gout = torch.randn_like(stats_k)
        gout[4:] = 0.0
        d_k = tt.train_backward(*args, off, gout, stats_k, chk_k, **kw)
        d_p = tt.train_backward_plain(*args, off, gout, stats_k, chk_k, **kw)
        # The whole plain chain: the plain backward on the plain forward's
        # own stats and checkpoints.
        d_chain = tt.train_backward_plain(*args, off, gout, stats_p, chk_p, **kw)
        for ref in (d_p, d_chain):
            for col in range(9):
                scale = float(ref[:, col].abs().max())
                assert float((d_k[:, col] - ref[:, col]).abs().max()) <= 1e-4 * scale
        assert float(d_k[:, 9:].abs().max()) == 0.0
