"""The training gradient's fixed summation order: the gather's transpose
(``ops/cuda/segment_sum.py``) and a whole train step.

On the CPU: the segment sum's plain version is bit-equal to the CPU's
``index_add_`` (both add each splat's rows in their index order); the
training gather's transpose on tests/test_torch_train.py's culled scene
is bit-equal to ``index_add_`` and within 1e-6 of each column's largest
of ``jax.vjp`` through the JAX package's plain gather (XLA's scatter-add
transpose); two train steps from one state give the same bits. On a
CUDA card (skipped here; chip_smoke.py runs the same checks on the H100):
the backward kernel and the segment-sum kernel, each launched twice on
the same inputs, give the same bits, and the segment sum equals its
plain version and the CPU's ``index_add_``.

The module imports no JAX at its top, so its CUDA tests run where JAX is
not installed.
"""

import numpy as np
import pytest
import torch

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.ops.compositing import gather_sorted_features_seg
from gaussianrenderer_tpu_torch.ops.cuda import segment_sum as seg
from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt
from gaussianrenderer_tpu_torch.ops.tile_train import train_kernel_compatible

#: The transpose against XLA's scatter-add, per column relative to the
#: column's largest: float order only (both add the same rows).
JAX_TRANSPOSE_REL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one intra-op thread (tests/test_torch_common.py's fixture:
    the suite runs a worker per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(m, n, d, seed, dtype=torch.int64):
    """``m`` rows of ``d`` floats of mixed magnitudes and their ids in
    ``[0, n)``, some ids repeated often, some absent."""
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.geometric(0.02, m) - 1, n - 1) if n else np.zeros(0)
    rows = rng.standard_normal((m, d)) * np.exp(3.0 * rng.standard_normal((m, 1)))
    return (torch.from_numpy(rows.astype(np.float32)),
            torch.from_numpy(ids.astype(np.int64)).to(dtype))


@pytest.mark.parametrize("m, n, d, dtype", [
    (5000, 300, 16, torch.int64),
    (5000, 300, 9, torch.int32),
    (40, 1000, 16, torch.int64),
    (0, 7, 16, torch.int64),
    (1, 1, 3, torch.int64),
])
def test_segment_sum_plain_is_index_add(m, n, d, dtype):
    rows, ids = _rows(m, n, d, seed=m + n + d)
    want = torch.zeros((n, d)).index_add_(0, ids.to(torch.int64), rows)
    got = seg.segment_sum(rows, ids, n)
    assert got.shape == (n, d) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(seg.segment_sum_plain(rows, ids, n), got)


def test_segments_keep_index_order():
    ids = torch.tensor([2, 0, 2, 1, 2, 0])
    order, offsets = seg.segments(ids, 4)
    assert order.tolist() == [1, 5, 3, 0, 2, 4]
    assert offsets.tolist() == [0, 2, 3, 6, 6]


def test_segment_sum_checks_its_inputs():
    with pytest.raises(ValueError, match="float32"):
        seg.segment_sum(torch.zeros((3, 2), dtype=torch.float64), torch.zeros(3), 1)
    with pytest.raises(ValueError, match="one per row"):
        seg.segment_sum(torch.zeros((3, 2)), torch.zeros(2, dtype=torch.int64), 1)


def test_gather_transpose_on_culled_scene():
    """The training gather's gradient on the culled scene: bit-equal to
    ``index_add_`` of the same cotangent rows, and within 1e-6 of each
    column's largest of XLA's scatter-add transpose through the JAX
    package's plain gather on its own assignment (the same instances)."""
    import jax
    import jax.numpy as jnp

    from gaussianrenderer_tpu.ops.compositing import gather_sorted_features as jax_gather
    from gaussianrenderer_tpu.ops.projection import preprocess_gaussians as jax_preprocess
    from gaussianrenderer_tpu.ops.tiling import build_sorted_instances as jax_build_sorted
    from gaussianrenderer_tpu_torch.convert import to_torch_params

    from test_torch_common import np_tree
    from test_torch_train import round_on_axis, train_setup

    (jp, jcfg, jcam), (_, pcfg, pcam), _ = train_setup(n=400, seed=6, extent=9.0)
    jp = round_on_axis(jp)
    pp = to_torch_params(np_tree(jp), "cpu")
    proj = gt.preprocess_gaussians(
        pp.to_scene(), pcam, width=pcfg.width, height=pcfg.height, tile_w=pcfg.tile_w,
        tile_h=pcfg.tile_h, tiles_x=pcfg.tiles_x, tiles_y=pcfg.tiles_y,
        sh_degree=pcfg.sh_degree, quantize_centers=False)
    asg = gt.build_sorted_instances(proj, tiles_x=pcfg.tiles_x, num_tiles=pcfg.num_tiles,
                                    near=pcam.near, far=pcam.far)
    feats = gt.build_features(proj).detach()
    n, c, k = feats.shape[0], int(asg.total_instances), pcfg.chunk_size
    assert c > 0 and (~proj.valid).sum() > 100
    cot = torch.from_numpy(np.random.default_rng(6).standard_normal((c + k, 16))
                           .astype(np.float32))
    leaf = feats.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(gather_sorted_features_seg(leaf, asg, k), leaf, cot)
    ids = asg.gaussian_id.to(torch.int64)
    want = torch.zeros((n, 16)).index_add_(0, ids, cot[:c])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))

    jproj = jax_preprocess(
        jp.to_scene(), jcam, width=jcfg.width, height=jcfg.height, tile_w=jcfg.tile_w,
        tile_h=jcfg.tile_h, tiles_x=jcfg.tiles_x, tiles_y=jcfg.tiles_y,
        sh_degree=jcfg.sh_degree, quantize_centers=False)
    jasg = jax_build_sorted(jproj, tiles_x=jcfg.tiles_x, num_tiles=jcfg.num_tiles,
                            capacity=jcfg.instance_capacity(n), near=jcam.near, far=jcam.far)
    jids = np.asarray(jasg.gaussian_id)
    np.testing.assert_array_equal(jids[:c], ids.numpy())
    jcot = np.zeros((jids.shape[0] + k, 16), np.float32)
    jcot[:c] = cot[:c].numpy()
    _, vjp = jax.vjp(lambda f: jax_gather(f, jasg, k), jnp.asarray(feats.numpy()))
    (xla,) = vjp(jnp.asarray(jcot))
    xla = np.asarray(xla)
    scale = np.abs(xla).max(axis=0)
    assert scale[:9].min() > 0
    err = np.abs(got.numpy() - xla).max(axis=0)
    assert (err <= JAX_TRANSPOSE_REL * np.maximum(scale, 1e-30)).all(), err / scale


def _train_state(n=300, seed=4, h=64, w=128, device="cpu"):
    """A seeded scene's params, a camera, a uniform target and a training
    config of 32×32 tiles (the train compositor's tiles)."""
    scene = gt.make_random_scene(n, seed=seed, extent=1.5, scale_range=(0.03, 0.12),
                                 device=device)
    cfg = gt.RenderConfig(height=h, width=w, num_tile_x=w // 32, num_tile_y=h // 32,
                          compositor="diff")
    cam = gt.Camera()
    cam.set_position([0.0, 0.3, 4.0])
    cam.set_look_at([0.0, 0.0, 0.0])
    cam.set_fov_y(60.0)
    cam.set_aspect_ratio(w / h)
    cam.set_clipping_planes(0.2, 100.0)
    cam.update_camera_matrices()
    camp = cam.params(cfg.k_sigma, device=device)
    target = torch.from_numpy(
        np.random.default_rng(seed).uniform(0, 1, (3, h, w)).astype(np.float32)).to(device)
    return gt.SceneParams.from_scene(scene), camp, target, cfg


def _bits_equal(a, b):
    return all((x is None and y is None) or torch.equal(
        x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))
        for x, y in zip(a, b))


def test_train_step_twice_from_one_state_is_bit_equal():
    """Two make_train_step steps (L1 + D-SSIM, the 3DGS Adam, the plain
    train compositor on 32×32 tiles) from one state: params, Adam moments
    and loss bit for bit, and the loss's gradients with the NDC probe's."""
    params, camp, target, cfg = _train_state()
    assert cfg.diff_kernel and train_kernel_compatible(cfg.tile_w, cfg.tile_h)
    opt = gt.make_3dgs_optimizer()
    step, _ = gt.make_train_step(cfg, optimizer=opt, loss_fn=gt.l1_dssim_loss)
    a = step(params, opt.init(params), camp, target)
    b = step(params, opt.init(params), camp, target)
    assert _bits_equal(a[0], b[0]) and _bits_equal(a[1].mu, b[1].mu)
    assert _bits_equal(a[1].nu, b[1].nu) and torch.equal(a[2], b[2])
    assert not _bits_equal(a[0], params)

    def grads():
        leaves = gt.SceneParams(*(None if p is None else p.clone().requires_grad_(True)
                                  for p in params))
        probe = torch.zeros((2, params.positions.shape[0]), requires_grad=True)
        loss = gt.l1_dssim_loss(leaves, camp, target, cfg, ndc_probe=probe)
        return torch.autograd.grad(loss, [p for p in leaves if p is not None] + [probe])

    g1, g2 = grads(), grads()
    assert _bits_equal(g1, g2) and float(g1[-1].abs().max()) > 0


# --------------------------------------------------------------- on a card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    return torch.device("cuda")


def test_segment_sum_kernel_twice_is_bit_equal_on_cuda():
    dev = _cuda()
    for m, n, d in ((200_000, 5000, 16), (3000, 20, 9), (10, 50, 16)):
        rows, ids = _rows(m, n, d, seed=m)
        before = seg.segment_sum.launches
        a = seg.segment_sum(rows.to(dev), ids.to(dev), n)
        b = seg.segment_sum(rows.to(dev), ids.to(dev), n)
        torch.cuda.synchronize()
        assert seg.segment_sum.launches == before + 2
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a, seg.segment_sum_plain(rows.to(dev), ids.to(dev), n))
        want = torch.zeros((n, d)).index_add_(0, ids, rows)
        assert torch.equal(a.cpu().view(torch.int32), want.view(torch.int32))


def test_backward_kernel_twice_is_bit_equal_on_cuda():
    dev = _cuda()
    params, camp, _, cfg = _train_state(n=3000, h=256, w=256, device=dev)
    with torch.no_grad():
        proj = gt.preprocess_gaussians(
            params.to_scene(), camp, width=cfg.width, height=cfg.height, tile_w=cfg.tile_w,
            tile_h=cfg.tile_h, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
            sh_degree=cfg.sh_degree, quantize_centers=False)
        asg = gt.build_sorted_instances(proj, tiles_x=cfg.tiles_x, num_tiles=cfg.num_tiles,
                                        near=camp.near, far=camp.far)
        sf = gather_sorted_features_seg(gt.build_features(proj), asg, cfg.chunk_size)
    kw = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
              tile_h=cfg.tile_h, chunk=cfg.chunk_size)
    off, n_chk = tt.chunk_offsets(asg.tile_start, asg.tile_count, cfg.chunk_size)
    args = (sf, asg.tile_start, asg.tile_count, off)
    stats, chk = tt.train_forward(*args, n_chk, **kw)
    gen = torch.Generator(device=dev).manual_seed(1)
    gout = torch.randn(stats.shape, generator=gen, device=dev)
    gout[4:] = 0.0
    a = tt.train_backward(*args, gout, stats, chk, **kw)
    b = tt.train_backward(*args, gout, stats, chk, **kw)
    torch.cuda.synchronize()
    assert float(a.abs().max()) > 0
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
