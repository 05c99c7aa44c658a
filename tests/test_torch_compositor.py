"""The port's tile compositor against the JAX package's Pallas compositor.

``composite_tiles_packed`` on CPU tensors runs its plain PyTorch version;
the JAX ``composite_tiles_packed`` runs its Pallas kernel in interpret
mode, as the JAX package's own tests run it on the CPU. Both get the
same packed records. Tolerance: max |Δ| ≤ 1e-3 on rgb and alpha — the
bound ``test_packed_vpu_quadratic_matches_mxu`` pins between the TPU
kernel's MXU quadratic (its default) and the direct form both ports use,
and the envelope of the per-pixel T ≥ 1e-3 stop rule. The depth row
Σ w·d carries the same weight error times the depth, so it is compared
after dividing by the frame's largest depth value.

The kernel itself runs only on a CUDA card (``chip_smoke.py`` holds it
against the plain version there); its test here skips without one.
"""

import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops.pallas import tile_render2 as jax_tr2

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.ops.cuda import tile_render2 as tr2

from test_torch_common import both_cameras, both_configs, both_scenes

MAX_ABS = 1e-3


def packed_inputs(n=2000, seed=0, cfg_kw=None, want_depth=False, device="cpu", **scene_kw):
    cfg_kw = cfg_kw or dict(height=128, width=160)
    _, cfg = both_configs(**cfg_kw)
    _, pcam, _ = both_cameras(cfg.width, cfg.height)
    ps = gt.make_random_scene(n, seed=seed, device=device, **scene_kw)
    pcam = type(pcam)(*(t.to(device) for t in pcam))
    proj = gt.preprocess_gaussians(
        ps, pcam, width=cfg.width, height=cfg.height, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
    )
    inst = gt.build_packed_instances(
        proj, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, near=pcam.near, far=pcam.far, want_depth=want_depth,
    )
    return inst, cfg


def geometry(cfg, chunk=None):
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
                tile_h=cfg.tile_h, width=cfg.width, height=cfg.height,
                chunk=chunk or cfg.packed_chunk)


def max_abs_rows(a, b, depth_row=None):
    """Per-row max |a − b|, the depth row divided by max |depth|."""
    out = []
    for i in range(a.shape[0]):
        x, y = np.asarray(a[i], np.float64), np.asarray(b[i], np.float64)
        if i == depth_row:
            scale = max(np.abs(y).max(), 1e-6)
            x, y = x / scale, y / scale
        out.append(float(np.abs(x - y).max()))
    return out


def test_fast_exp_bit_exact():
    x = np.concatenate([
        -np.linspace(0.0, 100.0, 200001), [0.0, -87.0, -88.0, -88.5, -1e30, 1e-7],
        -np.random.default_rng(0).exponential(3.0, 50000),
    ]).astype(np.float32)
    want = np.asarray(jax_tr2._fast_exp(x))
    got = tr2.fast_exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want, got)
    keep = (x > -80.0) & (x <= 0.0)
    ref = np.exp(x[keep].astype(np.float64))
    # The polynomial's 2.6e-6 fit error plus the f32 rounding of x·log2(e).
    assert np.abs(got[keep] / ref - 1.0).max() < 1e-5


_CASES = {
    "rgb": dict(),
    "alpha_depth": dict(out_alpha=True, want_depth=True),
    "chunk128_wide": dict(chunk=128, cfg_kw=dict(height=150, width=200),
                          scene_kw=dict(n=1500, seed=1, scale_range=(0.05, 0.5))),
    "tiles16_padded": dict(out_alpha=True, cfg_kw=dict(height=90, width=120,
                                                       num_tile_x=8, num_tile_y=6)),
}


@pytest.mark.parametrize("mxu_q", [True, False])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_matches_jax_compositor(case, mxu_q):
    spec = dict(_CASES[case])
    scene_kw = spec.pop("scene_kw", {})
    inst, cfg = packed_inputs(
        cfg_kw=spec.get("cfg_kw"), want_depth=spec.get("want_depth", False), **scene_kw
    )
    out_alpha = spec.get("out_alpha", False)
    kw = geometry(cfg, spec.get("chunk"))
    depth = inst.depth_f32
    got = gt.composite_tiles_packed(
        inst.packed_feats, inst.tile_start, inst.tile_count,
        out_alpha=out_alpha, depth_row=depth, **kw,
    ).numpy()
    want = np.asarray(jax_tr2.composite_tiles_packed(
        inst.packed_feats.numpy().view(np.uint32), inst.tile_start.numpy(),
        inst.tile_count.numpy(), out_alpha=out_alpha, mxu_q=mxu_q,
        depth_row=None if depth is None else depth.numpy(), **kw,
    ))
    assert got.shape == want.shape == (3 + out_alpha + (depth is not None),
                                       cfg.height, cfg.width)
    assert np.isfinite(got).all() and got[:3].max() > 0.1
    depth_row = got.shape[0] - 1 if depth is not None else None
    errs = max_abs_rows(got, want, depth_row)
    assert max(errs) <= MAX_ABS, errs


def test_plain_matches_jax_compositor_on_64x128_tiles():
    """8192-pixel tiles (``packed_compatible``; more pixels than one
    block's threads), against the JAX kernel's direct quadratic
    (``mxu_q=False``), the form the port computes. Its MXU form differs
    from the port by up to 1.7e-3 on this frame's alpha row (T summed over
    more lanes than on 32×32 tiles), beyond the 1e-3 its own test pins
    between the two forms on smaller tiles."""
    inst, cfg = packed_inputs(cfg_kw=dict(height=128, width=128, num_tile_x=2,
                                          num_tile_y=1))
    assert (cfg.tile_w, cfg.tile_h) == (64, 128) and cfg.packed_compatible
    kw = geometry(cfg)
    walked = torch.zeros(cfg.num_tiles, dtype=torch.int32)
    got = gt.composite_tiles_packed(
        inst.packed_feats, inst.tile_start, inst.tile_count, out_alpha=True,
        chunks_walked=walked, **kw,
    ).numpy()
    want = np.asarray(jax_tr2.composite_tiles_packed(
        inst.packed_feats.numpy().view(np.uint32), inst.tile_start.numpy(),
        inst.tile_count.numpy(), out_alpha=True, mxu_q=False, **kw,
    ))
    assert got.shape == want.shape == (4, cfg.height, cfg.width)
    assert np.isfinite(got).all() and got[:3].max() > 0.1
    assert max(max_abs_rows(got, want)) <= MAX_ABS
    assert int(walked.max()) >= 2  # tiles walk more than one chunk


def test_plain_tile_subset_and_chunk_counts():
    inst, cfg = packed_inputs(n=3000, seed=2, cfg_kw=dict(height=100, width=150))
    kw = geometry(cfg)
    walked = torch.full((cfg.num_tiles,), -1, dtype=torch.int32)
    full = gt.composite_tiles_packed(
        inst.packed_feats, inst.tile_start, inst.tile_count, out_alpha=True,
        chunks_walked=walked, **kw,
    )
    tiles = [0, 7, cfg.num_tiles - 1, 3]
    sub = tr2.composite_tiles_packed_plain(
        inst.packed_feats, inst.tile_start, inst.tile_count, out_alpha=True,
        tiles=tiles, **kw,
    )
    blocks = tr2.tile_blocks(full, tiles, tiles_x=cfg.tiles_x, tile_w=cfg.tile_w,
                             tile_h=cfg.tile_h)
    inside = tr2.tile_blocks(torch.ones_like(full[:1]), tiles, tiles_x=cfg.tiles_x,
                             tile_w=cfg.tile_w, tile_h=cfg.tile_h)
    torch.testing.assert_close(sub * inside, blocks, rtol=0, atol=0)
    k = cfg.packed_chunk
    start = inst.tile_start.long()
    need = (start + inst.tile_count.long() - (start // k) * k + k - 1) // k
    assert (walked >= 0).all() and (walked.long() <= need).all()
    assert (walked[inst.tile_count == 0] <= 1).all() and walked.max() >= 1


def test_plain_pair_counts_add_up():
    """``pair_counts`` splits every (in-image pixel, walked lane in range)
    pair of the computed tiles by AABB and by the pixel's stop: the four
    add up to the walked lanes times the tile's in-image pixels, and the
    two inside an AABB to a direct count over the boxes."""
    inst, cfg = packed_inputs(n=3000, seed=4, cfg_kw=dict(height=100, width=150))
    kw = geometry(cfg)
    walked = torch.zeros(cfg.num_tiles, dtype=torch.int32)
    counts = torch.zeros(4, dtype=torch.int64)
    tr2.composite_tiles_packed_plain(
        inst.packed_feats, inst.tile_start, inst.tile_count, chunks_walked=walked,
        pair_counts=counts, **kw,
    )
    k = cfg.packed_chunk
    box = inst.packed_feats[4].long() & 0xFFFFFFFF
    total = in_box = 0
    for t in range(cfg.num_tiles):
        s, c = int(inst.tile_start[t]), int(inst.tile_count[t])
        end = min(s + c, (s // k) * k + int(walked[t]) * k)
        w = min(cfg.width - (t % cfg.tiles_x) * cfg.tile_w, cfg.tile_w)
        h = min(cfg.height - (t // cfg.tiles_x) * cfg.tile_h, cfg.tile_h)
        b = box[s:max(end, s)]
        nx = (torch.minimum(b >> 16 & 0xFF, torch.tensor(w - 1)) - (b & 0xFF) + 1).clamp(min=0)
        ny = (torch.minimum(b >> 24, torch.tensor(h - 1)) - (b >> 8 & 0xFF) + 1).clamp(min=0)
        total += max(end - s, 0) * w * h
        in_box += int((nx * ny).sum())
    live_in, live_out, stopped_in, stopped_out = counts.tolist()
    assert live_in + live_out + stopped_in + stopped_out == total
    assert live_in + stopped_in == in_box
    assert live_in > 0 and stopped_in > 0


def test_wrapper_checks_take_every_packed_compatible_tile():
    """The kernel's argument checks (run here without a card) accept a tile
    exactly when ``RenderConfig.packed_compatible`` does, and the census
    exactly when the JAX kernel takes it (16-pixel-divisible sides, at most
    SAT_PAD = 128 blocks)."""
    empty = torch.zeros((5, 0), dtype=torch.int32)
    seen = {True: 0, False: 0}
    for tw in range(1, 261):
        for th in (1, 2, 3, 4, 7, 8, 16, 32, 48, 64, 100, 127, 128, 160, 255, 256):
            cfg = gt.RenderConfig(width=2 * tw, height=2 * th, num_tile_x=2, num_tile_y=2)
            assert (cfg.tile_w, cfg.tile_h) == (tw, th)
            ranges = torch.zeros(cfg.num_tiles, dtype=torch.int32)
            for with_sat in (False, True):
                want = cfg.packed_compatible and (not with_sat or (
                    tw % 16 == 0 and th % 16 == 0 and (tw // 16) * (th // 16) <= 128))
                try:
                    tr2.check_args(empty, ranges, ranges, with_sat=with_sat,
                                   **geometry(cfg))
                    got = True
                except ValueError:
                    got = False
                assert got == want, (tw, th, with_sat)
                seen[got] += 1
    assert seen[True] > 100 and seen[False] > 1000


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    inst, cfg = packed_inputs(n=500, seed=3)
    before = gt.composite_tiles_packed.launches
    out = gt.composite_tiles_packed(
        inst.packed_feats, inst.tile_start, inst.tile_count, **geometry(cfg)
    )
    assert out.shape == (3, cfg.height, cfg.width)
    assert gt.composite_tiles_packed.launches == before


def test_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check on the H100")
    for want_depth, cfg_kw in (
        (False, dict(height=600, width=800)),
        (True, dict(height=600, width=800)),
        (False, dict(height=512, width=768, num_tile_x=12, num_tile_y=4)),  # 64×128
        (True, dict(height=512, width=768, num_tile_x=12, num_tile_y=4)),
    ):
        inst, cfg = packed_inputs(n=20000, seed=0, want_depth=want_depth,
                                  cfg_kw=cfg_kw, device="cuda")
        kw = dict(geometry(cfg), out_alpha=want_depth, depth_row=inst.depth_f32)
        before = gt.composite_tiles_packed.launches
        k_out = gt.composite_tiles_packed(
            inst.packed_feats, inst.tile_start, inst.tile_count, **kw
        )
        torch.cuda.synchronize()
        assert gt.composite_tiles_packed.launches == before + 1
        p_out = tr2.composite_tiles_packed_plain(
            inst.packed_feats, inst.tile_start, inst.tile_count, **kw
        )
        diff = (k_out - p_out).abs()
        if want_depth:
            diff[-1] /= p_out[-1].abs().max().clamp_min(1e-6)
        assert float(diff.max()) <= 2e-3 and float(diff.mean()) <= 1e-5
    # The census on 128×128 tiles without an alpha row, as the culled
    # session calls it: 64 blocks a tile, its rectangles walked in groups
    # with their state kept between chunks. Census and chunks walked equal.
    inst, cfg = packed_inputs(
        n=20000, seed=0, device="cuda",
        cfg_kw=dict(height=512, width=768, num_tile_x=6, num_tile_y=4),
    )
    kw = geometry(cfg)
    walked = [torch.zeros(cfg.num_tiles, dtype=torch.int32, device="cuda")
              for _ in range(2)]
    k_out, k_sat = gt.composite_tiles_packed(
        inst.packed_feats, inst.tile_start, inst.tile_count, with_sat=True,
        chunks_walked=walked[0], **kw
    )
    p_out, p_sat = tr2.composite_tiles_packed_plain(
        inst.packed_feats, inst.tile_start, inst.tile_count, with_sat=True,
        chunks_walked=walked[1], **kw
    )
    assert k_sat.shape == (cfg.num_tiles * 64,) and torch.equal(k_sat, p_sat)
    assert torch.equal(walked[0], walked[1])
    diff = (k_out - p_out).abs()
    assert float(diff.max()) <= 2e-3 and float(diff.mean()) <= 1e-5
