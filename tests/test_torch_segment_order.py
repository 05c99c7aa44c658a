"""The training gather's transpose without a sort: the tile assignment's
``segment_slot`` and ``segment_start`` (``ops/tiling.py``) against the
stable argsort of ``gaussian_id`` and its searched offsets
(``ops/cuda/segment_sum.segments``), and the gather's backward through
them against ``index_add_`` and the argsort route.

Scenes: narrow splats, wide splats (rects up to dozens of tiles), a
culled scene with many invalid splats, and multi-device strips (a band
of tile rows, and a block of rows and columns) built as
``parallel/multichip.py`` builds them, with the whole grid's depth width.
On a CUDA card (skipped here; chip_smoke.py runs the same checks on the
H100) the ordered entry point's kernel against its plain version.

Also the packaging of the port's compiled sources: every source that
``_build`` compiles ships as package data (``pyproject.toml``).

The module imports no JAX, so its CUDA test runs where JAX is not
installed.
"""

import fnmatch
import os
import tomllib

import numpy as np
import pytest
import torch

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch import _build
from gaussianrenderer_tpu_torch.ops.compositing import gather_sorted_features_seg
from gaussianrenderer_tpu_torch.ops.cuda import segment_sum as seg
from gaussianrenderer_tpu_torch.parallel.multichip import _global_depth_bits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one intra-op thread (tests/test_torch_common.py's fixture:
    the suite runs a worker per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: name: (splats, seed, extent, scale_range, camera position).
_SCENES = {
    "narrow": (3000, 1, 2.0, (0.01, 0.12), (0.5, -0.4, 5.5)),
    "wide": (1500, 2, 2.0, (0.05, 0.5), (0.5, -0.4, 5.5)),
    "culled": (3000, 3, 9.0, (0.05, 0.2), (0.0, 0.0, 5.0)),
}
_H, _W = 96, 128


def _projected(name):
    n, seed, extent, scales, pos = _SCENES[name]
    scene = gt.make_random_scene(n, seed=seed, extent=extent, scale_range=scales,
                                 device="cpu")
    cfg = gt.RenderConfig(height=_H, width=_W, num_tile_x=_W // 16, num_tile_y=_H // 16,
                          compositor="diff")
    cam = gt.Camera()
    cam.set_position(list(pos))
    cam.set_look_at([0.0, 0.0, 0.0])
    cam.set_fov_y(60.0)
    cam.set_aspect_ratio(_W / _H)
    cam.set_clipping_planes(0.2, 100.0)
    cam.update_camera_matrices()
    camp = cam.params(cfg.k_sigma, device="cpu")
    proj = gt.preprocess_gaussians(
        scene, camp, width=cfg.width, height=cfg.height, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        sh_degree=cfg.sh_degree, quantize_centers=False)
    return proj, cfg, camp


def _strip(proj, cfg, y0, rows, x0=None, cols=None):
    """The projection as a device of ``parallel/multichip.py`` sees its
    strip: tile rects clamped to tile rows [y0, y0 + rows) (and columns
    [x0, x0 + cols)) and shifted to the strip's origin; a splat that
    misses the strip is invalid there."""
    tmin_x, tmin_y = proj.tile_min[:, 0], proj.tile_min[:, 1]
    tmax_x, tmax_y = proj.tile_max[:, 0], proj.tile_max[:, 1]
    tmin_y = torch.clamp_min(tmin_y, y0) - y0
    tmax_y = torch.clamp_max(tmax_y, y0 + rows - 1) - y0
    valid = proj.valid & (tmin_y <= tmax_y)
    if x0 is not None:
        tmin_x = torch.clamp_min(tmin_x, x0) - x0
        tmax_x = torch.clamp_max(tmax_x, x0 + cols - 1) - x0
        valid = valid & (tmin_x <= tmax_x)
    return proj._replace(valid=valid, tile_min=torch.stack([tmin_x, tmin_y], -1),
                         tile_max=torch.stack([tmax_x, tmax_y], -1))


def _assignment(case):
    name, _, strip = case.partition("/")
    proj, cfg, camp = _projected(name)
    if not strip:
        asg = gt.build_sorted_instances(proj, tiles_x=cfg.tiles_x, num_tiles=cfg.num_tiles,
                                        near=camp.near, far=camp.far)
        return proj, cfg, asg
    # A band of two tile rows, or a block of two rows and three columns.
    geo = dict(y0=2, rows=2) if strip == "rows" else dict(y0=2, rows=2, x0=3, cols=3)
    sp = _strip(proj, cfg, **geo)
    asg = gt.build_sorted_instances(
        sp, tiles_x=cfg.tiles_x, num_tiles=cfg.tiles_x * geo["rows"], near=camp.near,
        far=camp.far, depth_bits=_global_depth_bits(cfg))
    return sp, cfg, asg


_CASES = ["narrow", "wide", "culled", "narrow/rows", "wide/rows", "wide/block"]


@pytest.mark.parametrize("case", _CASES)
def test_segments_are_the_stable_argsort(case):
    """``segment_slot`` and ``segment_start`` equal the stable argsort of
    ``gaussian_id`` and its searched offsets, element for element."""
    proj, _, asg = _assignment(case)
    n, c = proj.valid.shape[0], int(asg.total_instances)
    assert asg.segment_slot.dtype == asg.segment_start.dtype == torch.int32
    assert asg.segment_slot.shape == (c,) and asg.segment_start.shape == (n + 1,)
    order, offsets = seg.segments(asg.gaussian_id, n)
    assert torch.equal(asg.segment_slot.to(torch.int64), order)
    assert torch.equal(asg.segment_start.to(torch.int64), offsets)
    # The cases hold what they are meant to: splats over many tiles (all
    # six of the block's), and Gaussians with no instance.
    counts = offsets[1:] - offsets[:-1]
    assert c > 500
    if case in ("wide", "wide/rows"):
        assert int(counts.max()) >= 12
    if case == "wide/block":
        assert int(counts.max()) == 6
    if case == "culled" or "/" in case:
        assert int((counts == 0).sum()) > 50
    if case == "culled":
        assert int((~proj.valid).sum()) > 1000


@pytest.mark.parametrize("case", _CASES)
def test_gather_backward_is_index_add_and_argsort_route(case):
    """The gather's transpose through the assignment's segments equals
    ``index_add_`` of the same cotangent rows and the argsort route
    (``segment_sum``) bit for bit."""
    proj, cfg, asg = _assignment(case)
    feats = gt.build_features(proj).detach()
    n, c, k = feats.shape[0], int(asg.total_instances), cfg.chunk_size
    rng = np.random.default_rng(len(case))
    cot = rng.standard_normal((c + k, 16)) * np.exp(2.0 * rng.standard_normal((c + k, 1)))
    cot = torch.from_numpy(cot.astype(np.float32))
    leaf = feats.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(gather_sorted_features_seg(leaf, asg, k), leaf, cot)
    ids = asg.gaussian_id.to(torch.int64)
    want = torch.zeros((n, 16)).index_add_(0, ids, cot[:c])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    argsort = seg.segment_sum(cot[:c].contiguous(), ids, n)
    assert torch.equal(got.view(torch.int32), argsort.view(torch.int32))


def test_train_step_neither_sorts_nor_searches(monkeypatch):
    """A training step (its loss and its gradients) calls neither
    ``torch.argsort`` nor ``torch.searchsorted``: the gather's transpose
    takes its segments from the forward's emission."""
    params, camp = _train_params()
    cfg = gt.RenderConfig(height=64, width=128, num_tile_x=4, num_tile_y=2,
                          compositor="diff")
    target = torch.from_numpy(
        np.random.default_rng(0).uniform(0, 1, (3, 64, 128)).astype(np.float32))
    leaves = gt.SceneParams(*(None if p is None else p.clone().requires_grad_(True)
                              for p in params))

    def refuse(*args, **kwargs):
        raise AssertionError("the training step sorted by id or searched")

    monkeypatch.setattr(torch, "argsort", refuse)
    monkeypatch.setattr(torch, "searchsorted", refuse)
    loss = gt.l1_dssim_loss(leaves, camp, target, cfg)
    grads = torch.autograd.grad(loss, [p for p in leaves if p is not None])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[0].abs().max()) > 0


def _train_params():
    scene = gt.make_random_scene(400, seed=4, extent=1.5, scale_range=(0.03, 0.12),
                                 device="cpu")
    cam = gt.Camera()
    cam.set_position([0.0, 0.3, 4.0])
    cam.set_look_at([0.0, 0.0, 0.0])
    cam.set_fov_y(60.0)
    cam.set_aspect_ratio(2.0)
    cam.set_clipping_planes(0.2, 100.0)
    cam.update_camera_matrices()
    return gt.SceneParams.from_scene(scene), cam.params(3.0, device="cpu")


def _rows(m, n, d, seed):
    """``m`` rows of ``d`` floats of mixed magnitudes and their ids in
    ``[0, n)``, some ids repeated often, some absent."""
    rng = np.random.default_rng(seed)
    ids = np.minimum(rng.geometric(0.02, m) - 1, n - 1)
    rows = rng.standard_normal((m, d)) * np.exp(3.0 * rng.standard_normal((m, 1)))
    return (torch.from_numpy(rows.astype(np.float32)),
            torch.from_numpy(ids.astype(np.int64)))


@pytest.mark.parametrize("m, n, d, idx", [
    (5000, 300, 16, torch.int32),
    (5000, 300, 9, torch.int64),
    (3000, 4000, 12, torch.int32),
])
def test_ordered_plain_is_argsort_route(m, n, d, idx):
    """``segment_sum_ordered`` on the argsort's ``(order, offsets)`` in
    either index width is ``segment_sum`` bit for bit; on a reversed
    order it adds each segment's rows the other way round."""
    rows, ids = _rows(m, n, d, seed=m + d)
    order, offsets = seg.segments(ids, n)
    want = seg.segment_sum(rows, ids, n)
    got = seg.segment_sum_ordered(rows, order.to(idx), offsets.to(idx))
    assert got.shape == (n, d) and torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(seg.segment_sum_ordered_plain(rows, order, offsets), got)
    # Each segment's rows in reverse: the same rows, added in another order.
    rev = order.clone()
    for s in range(n):
        lo, hi = int(offsets[s]), int(offsets[s + 1])
        rev[lo:hi] = order[lo:hi].flip(0)
    back = seg.segment_sum_ordered(rows, rev, offsets)
    serial = torch.zeros((n, d))
    for s in range(n):
        for j in rev[int(offsets[s]):int(offsets[s + 1])].tolist():
            serial[s] += rows[j]
    assert torch.equal(back.view(torch.int32), serial.view(torch.int32))


def test_ordered_checks_its_inputs():
    rows, order, offsets = torch.zeros((3, 2)), torch.zeros(3, dtype=torch.int32), \
        torch.tensor([0, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        seg.segment_sum_ordered(rows.double(), order, offsets)
    with pytest.raises(ValueError, match="one per row"):
        seg.segment_sum_ordered(rows, order[:2], offsets)
    with pytest.raises(ValueError, match="int32 or int64"):
        seg.segment_sum_ordered(rows, order.float(), offsets)
    with pytest.raises(ValueError, match=r"\(n \+ 1,\)"):
        seg.segment_sum_ordered(rows, order, offsets[:0])
    proj, cfg, asg = _assignment("narrow")
    with pytest.raises(ValueError, match="segments cover"):
        gather_sorted_features_seg(gt.build_features(proj)[1:], asg, cfg.chunk_size)


def test_compiled_sources_ship_as_package_data():
    """Every source the port compiles at first use (``_build.CUDA``'s
    kernels, ``_build.NATIVE``'s readers) matches a package-data pattern
    of its package in ``pyproject.toml``, so a built wheel can build it."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    native = sorted(f[:-4] for f in os.listdir(_build.NATIVE.src_dir) if f.endswith(".cpp"))
    sources = [_build.CUDA.source(n) for n in _build.SOURCES]
    sources += [_build.NATIVE.source(n) for n in native]
    assert "segment_sum" in _build.SOURCES and native == ["colmap_loader", "ply_loader"]
    for path in sources:
        assert os.path.isfile(path), path
        rel = os.path.relpath(path, REPO)
        shipped = False
        for pkg, patterns in data.items():
            pkg_dir = pkg.replace(".", os.sep) + os.sep
            if rel.startswith(pkg_dir):
                inner = rel[len(pkg_dir):]
                shipped |= any(fnmatch.fnmatch(inner, p) for p in patterns)
        assert shipped, f"{rel} matches no package-data pattern"


# --------------------------------------------------------------- on a card
def test_ordered_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    dev = torch.device("cuda")
    for m, n, d in ((200_000, 5000, 16), (3000, 20, 9), (10, 50, 16), (4000, 300, 12)):
        rows, ids = _rows(m, n, d, seed=m)
        order, offsets = seg.segments(ids, n)
        args = (rows.to(dev), order.to(torch.int32).to(dev), offsets.to(torch.int32).to(dev))
        before = seg.segment_sum.launches
        a = seg.segment_sum_ordered(*args)
        b = seg.segment_sum_ordered(*args)
        torch.cuda.synchronize()
        assert seg.segment_sum.launches == before + 2
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a, seg.segment_sum_ordered_plain(*args))
        assert torch.equal(a, seg.segment_sum(rows.to(dev), ids.to(dev), n))
        want = torch.zeros((n, d)).index_add_(0, ids, rows)
        assert torch.equal(a.cpu().view(torch.int32), want.view(torch.int32))
