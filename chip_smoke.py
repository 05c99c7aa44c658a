#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``gaussianrenderer_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); builds the port's CUDA
kernels from the sources in this checkout into build/torch_kernels/.
Phases, each ending with ``torch.cuda.synchronize()`` and a line giving
its elapsed seconds:

1. device           — the card's name and power limit (nvidia-smi);
2. build            — nvcc build of every kernel (seconds, registers);
3. scene-3m         — the bench.py headline scene (3M splats, Morton order);
4. kernel-vs-plain  — each kernel against its plain PyTorch version on the
                      card: the compositor, without and with its saturation
                      census (``with_sat``), on three 800×600 packed frames
                      (plain rgb; alpha + depth + background; wide splats)
                      and 32 tiles of the 3M-splat 1080p frame (the 16 with
                      the most instances, 16 seeded random); the table
                      lookup, bit for bit, on the inputs the culled 3M
                      frames give it (the pyramid of frame 1's cutoff
                      image sampled by all 3M splats; frame 2's candidate
                      lanes), with out-of-range indices, and on a 4K
                      pyramid (more than 16,384 entries); the lookup's
                      times beside its bound and one ``torch.take``;
5. goldens          — the five tests/fixtures/golden_*.npz setups rendered
                      by the port, PSNR ≥ 40 dB against each framebuffer;
6. full-3m, profile-3m, full-trained-500k
                    — the main path through ``render_frame`` at full width:
                      3M splats at 1920×1080 (bench camera) and
                      data/trained_500k.ply at 1920×1080; counts beside
                      the JAX package's recorded ones, median frame, stage
                      and kernel times, and the kernel's launch count;
                      a torch.profiler pass over the 3M frame (device busy
                      share, device time by kernel and by PyTorch op);
7. session-3m, session-trained-500k
                    — the main path of the culled session: ``make_renderer``
                      with ``sat_cull=True`` on the same two scenes at
                      1920×1080. Frame 1 culls nothing and equals the
                      unculled frame; frame 2 at the same pose culls, has no
                      risk blocks and stays within 2e-5 of the unculled
                      frame; an orbit of 10 frames at 3°/frame stays
                      ≥ 40 dB against unculled renders (5°/frame printed,
                      not gated); frame times, stage times and each
                      kernel's launches per frame;
8. train-kernel-vs-plain
                    — both training kernels against their plain versions
                      on every tile of the first training step's frame
                      below and of a heavy-overdraw case (16k large splats
                      at 256×256): forward rgb and T within 1e-4, the
                      gradient per column within 1e-4 of the plain
                      version's largest, columns 9–15 and the lanes past
                      the last tile exactly 0; kernel, plain and bound ms;
9. train-500k       — the training main path: ``make_train_step`` with
                      ``make_3dgs_optimizer`` and ``l1_dssim_loss`` on
                      data/trained_500k.ply at 640×480 (the fitting
                      config), 30 steps over 4 orbit views whose targets
                      are the file's own renders, from a seeded
                      perturbation: loss finite and falling, no NaN
                      gradient, one launch of each kernel per step; step
                      ms, CUDA-event stage ms, PSNR before and after, and
                      a torch.profiler pass over 3 steps;
10. train-bench-shape
                    — step ms at tools/train_bench.py's shape (500k
                      random splats, 800×800, Adam 1e-2, MSE).
11. gemm            — the GEMM harness: the port's apps/matrix_test at
                      N = 8192 on random and on ones inputs (exit 0: the
                      kernel within 1e-2 of torch.mm, out[0, 0] == N on
                      ones); the kernel within GEMM_MAX_REL of its plain
                      version at 8192³, every entry N on ones, and on the
                      edge shapes; kernel, plain and torch.mm ms, TFLOP/s,
                      the 1.11 ms bound, launches;
12. block-sort      — block_sort_runs at C = 5,586,944 (bench_3m's
                      instances rounded up to run 2048): one call, one
                      launch; the kernel bit-equal to its plain version on
                      all 9 rows for random u32 keys (half ≥ 2³¹) and
                      tie-heavy keys at runs 256, 2048, 4096 and 16384;
                      kernel, plain and library (torch.sort of the key
                      view + one gather) ms beside the bound;
13. sort-harness    — the port's apps/onesweep and apps/radix_test with
                      their defaults on the card: exit 0, every JSONL
                      record (build/radix_bench_port.jsonl) true on its
                      checks.

Then one JSON line of per-kernel numbers (six kernels), the card line
again, and as the last line ``{"ok": true, "device": {...}}``. Any failed
check raises and the script exits non-zero without the ok line. Logs go
to stderr.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
#: Where every scene and frame of the run lives.
DEVICE = "cuda"

#: Tolerances of the kernel against its plain version on the card: the
#: per-pixel stop rule (T ≥ 1e-3) can flip on a float-order difference,
#: which moves one weight by at most ~1e-3 (max), and must stay rare (mean).
KERNEL_MAX_ABS = 2e-3
KERNEL_MEAN_ABS = 1e-5
GOLDEN_MIN_PSNR = 40.0
#: The repo's fidelity gate, here for culled orbit frames against
#: unculled renders of the same pose.
ORBIT_MIN_PSNR = 40.0

#: Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
#: cores, dense bf16 on the tensor cores and HBM bandwidth, at the 700 W
#: power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
#: fp32/int operations per (pixel, instance lane) pair the compositor
#: needs. Every pair of an in-image pixel and a walked lane pays the u8
#: AABB test (two unsigned compares). A pair inside the lane's AABB also
#: pays the splat: offsets 2, quadratic 7, exponent argument 2, fast_exp
#: 18, clamp 1, alpha test 1; and the blend: T test 1, weight 1, colour
#: accumulation 6, T update 2. Depth accumulation adds 2 when the frame
#: has a depth row.
OPS_BOX_TEST = 2
OPS_IN_BOX = OPS_BOX_TEST + 31 + 10
OPS_DEPTH = 2
#: Bytes of one packed instance record (5 u32 rows).
RECORD_BYTES = 20

#: The JAX package's counts for the same frames, which the port must
#: equal (they do not depend on the device): BENCH_r05.json, a TPU run
#: of bench.py (3M bench scene), and the current JAX emitter run on the
#: CPU by ``PYTHONPATH=. python tests/test_torch_scene_counts.py``
#: (trained_500k).
REF_COUNTS = {
    "bench_3m": {"num_instances": 5585012, "num_culled": 2922824},
    "trained_500k": {"num_instances": 1592730, "num_culled": 434930},
}


#: The TPU run's same-pose frame 2 of bench_3m with the cull on
#: (BENCH_r05.json tail, "sat-cull warm"): printed beside the port's
#: numbers, never gated (the TPU's quadratic is the MXU form, so a few
#: blocks may saturate in another chunk).
TPU_SAT_FRAME2 = {"sat_culled": 2113137, "num_instances": 1852983}
#: Same-pose frame 2 against the unculled frame: culled splats carry no
#: weight, so only summation order may differ (tests/test_satcull.py).
SAT_EXACT_ATOL = 2e-5
#: The orbit's step (tests/test_satcull.py) and bench.py's.
ORBIT_DEG = 3.0
BENCH_ORBIT_DEG = 5.0
#: 4K frame's saturation grid (3840×2160 in 16-px blocks): its pyramid has
#: more than 16,384 entries.
GRID_4K = (135, 240)

#: The train kernels against their plain versions on the card: forward
#: rows (rgb, T) max |Δ|, and the gradient per column relative to the
#: plain version's largest (float summation order only: both versions
#: compute alpha with the same rounding and the same exp).
TRAIN_FWD_MAX_ABS = 1e-4
TRAIN_GRAD_REL = 1e-4
#: The training main path: steps, views and the view spacing on the orbit.
TRAIN_STEPS = 30
TRAIN_POSES = 4
TRAIN_POSE_DEG = 8.0
TRAIN_H, TRAIN_W = 480, 640
#: fp32 operations per (in-image pixel, walked lane) pair of the train
#: kernels that the function needs. Nothing once the pixel has stopped
#: (t_before < 1e-3: gates are a prefix). While it is live: outside the
#: lane's AABB the 4-compare box test; inside with alpha below 1e-3 the
#: alpha alone, box 4, offsets 2, quadratic 7, clip 2, exponent argument
#: 1, expf 8, opacity 1, clamp 1, alpha test 1 (27); inside and weighted
#: the forward adds t_before 1, gate 1, weight 1, colour accumulation 6,
#: carry 2 (38), and the backward is the alpha and carry recompute
#: without the colours (32), g·c 5, y 1, suffix 2, ∂alpha 5, ∂op 2, ∂md²
#: 3, the five geometry terms 17, colour terms 6 (73).
OPS_TRAIN_BOX_TEST = 4
OPS_TRAIN_ALPHA = 27
OPS_TRAIN_FWD = 38
OPS_TRAIN_BWD = 73

#: The GEMM harness (apps/matrix_test) at its default N.
GEMM_N = 8192
#: GEMM kernel against its plain version, max |Δ| over the largest |entry|.
#: bf16 products are exact in f32, so only the f32 summation differs: the
#: plain version sums in cuBLAS's f32 SGEMM order, the kernel in the tensor
#: cores' accumulator, whose rounding inside an MMA is not IEEE
#: round-to-nearest. At K = 8192 on an H100 the kernel sits 9.8e-6 from
#: the plain version, as far as torch.mm's own tensor-core product (both
#: printed); the gate is twice that.
GEMM_MAX_REL = 2e-5
#: (M, K, N, block): an edge shape no 128-tile divides, with 8-blocks;
#: an odd shape with 1-blocks (the kernel's element-wise load path).
GEMM_EDGE_SHAPES = ((264, 136, 328, 8), (37, 13, 29, 1))
#: The block sort at the render path's instance count: bench_3m's
#: 5,585,012 instances rounded up to the default run of 2048.
BLOCK_SORT_C = 5_586_944
#: Runs held against the plain version: the smallest, the default, twice
#: the default, the kernel's largest.
BLOCK_SORT_RUNS = (256, 2048, 4096, 16384)
#: Operations per compare-exchange pair and substage: one compare, and a
#: select for each of the 9 rows of both outputs.
OPS_COMPARE_EXCHANGE = 19


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def out(obj):
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


class Phase:
    """Times one phase: synchronizes the card at its end and prints the
    elapsed seconds on a line of their own."""

    def __init__(self, name, torch):
        self.name, self.torch = name, torch

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, exc_type, exc, tb):
        self.torch.cuda.synchronize()
        if exc_type is None:
            out(f"phase {self.name}: {time.perf_counter() - self.t0:.2f} s")
        return False


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def psnr(a, b, peak=1.0):
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * math.log10(peak * peak / mse)


# --------------------------------------------------------------- scene setups
def look_camera(gt, pos, aspect, fov=70.0, near=0.2, look_at=(0.0, 0.0, 0.0)):
    cam = gt.Camera()
    cam.set_position(list(pos))
    cam.set_look_at(list(look_at))
    cam.set_fov_y(fov)
    cam.set_aspect_ratio(aspect)
    cam.set_clipping_planes(near, 100.0)
    cam.update_camera_matrices()
    return cam


def golden_setup(name, device=None):
    """The pinned (scene, camera, cfg, time) of tests/fixtures/golden_<name>,
    rebuilt with the port's own generator and loader; the same setups as
    tools/make_golden_fixture.py's ``golden_setup``."""
    import gaussianrenderer_tpu_torch as gt

    device = device or DEVICE
    aspect = 160 / 128
    cam = look_camera(gt, (0.5, -0.4, 5.5), aspect, fov=55.0)
    if name == "scene0":
        scene = gt.make_random_scene(800, seed=123, device=device)
        cfg = gt.RenderConfig(height=128, width=160, compositor="packed")
        return scene, cam, cfg, None
    if name == "deg3":
        scene = gt.make_random_scene(600, seed=7, sh_degree=3, device=device)
        cfg = gt.RenderConfig(height=128, width=160, compositor="packed", sh_degree=3)
        return scene, cam, cfg, None
    if name == "motion":
        scene = gt.make_random_scene(500, seed=9, spacetime=True, device=device)
        cfg = gt.RenderConfig(height=128, width=160, compositor="packed")
        return scene, cam, cfg, 0.37
    if name == "ewa":
        scene = gt.make_random_scene(
            600, seed=5, scale_range=(0.004, 0.08), device=device
        )
        cfg = gt.RenderConfig(
            height=128, width=160, compositor="packed",
            ewa_dilation=0.3, ewa_compensate=True,
        )
        return scene, cam, cfg, None
    if name == "trained":
        scene = gt.load_ply(
            os.path.join(REPO, "tests", "fixtures", "trained.ply"),
            max_sh_degree=1, device=device,
        )
        cfg = gt.RenderConfig(
            height=128, width=160, compositor="packed", sh_degree=1, tier_boost=1
        )
        return scene, look_camera(gt, (3.9, 1.5, 3.9), aspect), cfg, None
    raise ValueError(f"unknown golden {name!r}")


GOLDEN_NAMES = ("scene0", "deg3", "motion", "ewa", "trained")


def bench_3m_setup(device=None):
    """bench.py's headline frame: 3M splats, Morton-ordered, 1920×1080,
    camera at (0, 1, 8) looking at the origin, fov 70°, clip 0.2–100."""
    import gaussianrenderer_tpu_torch as gt

    device = device or DEVICE
    scene = gt.make_random_scene(
        3_000_000, seed=0, extent=4.0, scale_range=(0.004, 0.03), device=device
    ).morton_sorted()
    cfg = gt.RenderConfig(height=1080, width=1920)
    return scene, look_camera(gt, (0.0, 1.0, 8.0), 1920 / 1080), cfg


def trained_500k_setup(device=None):
    """tools/bench_suite.py config 8: data/trained_500k.ply (SH degree 1,
    Morton-ordered) at 1920×1080 from the training orbit (3.9, 1.7, 3.9)."""
    import gaussianrenderer_tpu_torch as gt

    device = device or DEVICE
    scene = gt.load_ply(
        os.path.join(REPO, "data", "trained_500k.ply"), max_sh_degree=1, device=device
    ).morton_sorted()
    cfg = gt.RenderConfig(height=1080, width=1920, sh_degree=1)
    return scene, look_camera(gt, (3.9, 1.7, 3.9), 1920 / 1080), cfg


# ------------------------------------------------------------------- helpers
def frame_stages(gt, scene, cam, cfg, want_depth):
    """The stages of one static frame before the compositor, as
    zero-argument callables: (preprocess, emit) with emit(proj) → inst."""
    camp = cam.params(cfg.k_sigma, device=DEVICE)

    def preprocess():
        return gt.preprocess_gaussians(
            scene, camp, width=cfg.width, height=cfg.height,
            tile_w=cfg.tile_w, tile_h=cfg.tile_h,
            tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, sh_degree=cfg.sh_degree,
        )

    def emit(proj):
        return gt.build_packed_instances(
            proj, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
            tile_w=cfg.tile_w, tile_h=cfg.tile_h,
            near=camp.near, far=camp.far, want_depth=want_depth,
        )

    return preprocess, emit


def packed_frame(gt, scene, cam, cfg, want_depth):
    """Projection + emission of one frame: the compositor's inputs."""
    preprocess, emit = frame_stages(gt, scene, cam, cfg, want_depth)
    return emit(preprocess())


def comp_kwargs(cfg, out_alpha):
    return dict(
        tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
        tile_h=cfg.tile_h, width=cfg.width, height=cfg.height,
        chunk=cfg.packed_chunk, out_alpha=out_alpha,
    )


def compare(torch, name, kernel_out, plain_out, rows, depth_rows=()):
    """Max and mean |kernel − plain| per row; depth rows are divided by the
    frame's largest |depth| first (their error is a weight error times d)."""
    res = {"case": name}
    worst = 0.0
    for i, row in enumerate(rows):
        a, b = kernel_out[i], plain_out[i]
        if row in depth_rows:
            scale = max(float(b.abs().max()), 1e-6)
            a, b = a / scale, b / scale
        d = (a - b).abs()
        mx, mean = float(d.max()), float(d.mean())
        res[row] = {"max_abs": mx, "mean_abs": mean}
        check(
            mx <= KERNEL_MAX_ABS and mean <= KERNEL_MEAN_ABS and math.isfinite(mx),
            f"{name} {row}: kernel vs plain max {mx:.3g} mean {mean:.3g}",
        )
        worst = max(worst, mx)
    out(res)
    return worst


def cuda_ms(torch, fn, reps):
    """Median of ``reps`` CUDA-event timings of ``fn`` (after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def compositor_bound_ms(torch, inst, cfg, walked, nc):
    """Least time for this frame's compositor work on an H100: the larger
    of the operations the walked lanes need over the fp32 peak and the
    bytes the function must move (records, depth row and ranges in,
    framebuffer out) over the HBM peak.

    Operations count what this frame's data needs: each walked lane (up
    to its tile's early exit, ``walked`` chunks) costs ``OPS_IN_BOX`` for
    each in-image pixel of its tile inside its u8 AABB and
    ``OPS_BOX_TEST`` for every other in-image pixel; pixels past the image
    edge cost nothing. Returns (ms, "operations" | "bytes", pairs walked,
    pairs inside an AABB)."""
    k = cfg.packed_chunk
    i64 = torch.int64
    dev = inst.tile_count.device
    count = inst.tile_count.to(i64)
    start = inst.tile_start.to(i64)
    reach = torch.minimum(start + count, (start // k) * k + walked.to(i64) * k)
    tiles = torch.arange(cfg.num_tiles, device=dev)
    # Tile of each record: the ranges are contiguous and in tile order.
    lane_tile = torch.repeat_interleave(tiles, count)
    keep = torch.arange(lane_tile.numel(), device=dev) < reach[lane_tile]
    lane_tile = lane_tile[keep]
    box = inst.packed_feats[4][keep].to(i64) & 0xFFFFFFFF
    # In-image extent of each tile (the last column and row may be cut).
    span_x = torch.clamp(cfg.width - (tiles % cfg.tiles_x) * cfg.tile_w, max=cfg.tile_w)
    span_y = torch.clamp(cfg.height - (tiles // cfg.tiles_x) * cfg.tile_h,
                         max=cfg.tile_h)
    sx, sy = span_x[lane_tile], span_y[lane_tile]
    nx = torch.clamp(torch.minimum(box >> 16 & 0xFF, sx - 1) - (box & 0xFF) + 1, min=0)
    ny = torch.clamp(torch.minimum(box >> 24, sy - 1) - (box >> 8 & 0xFF) + 1, min=0)
    pairs = int((sx * sy).sum())
    in_box = int((nx * ny).sum())
    ops_in = OPS_IN_BOX + (OPS_DEPTH if inst.depth_f32 is not None else 0)
    ops = in_box * ops_in + (pairs - in_box) * OPS_BOX_TEST
    ops_s = ops / PEAK_FP32_FLOPS
    n_lanes = inst.packed_feats.shape[1]
    n_bytes = (
        n_lanes * (RECORD_BYTES + (4 if inst.depth_f32 is not None else 0))
        + 8 * cfg.num_tiles
        + 4 * nc * cfg.height * cfg.width
    )
    bytes_s = n_bytes / PEAK_HBM_BYTES
    if ops_s >= bytes_s:
        return ops_s * 1e3, "operations", pairs, in_box
    return bytes_s * 1e3, "bytes", pairs, in_box


# -------------------------------------------------------------------- phases
def phase_kernel_vs_plain(torch, gt, big):
    from gaussianrenderer_tpu_torch.ops.cuda.tile_render2 import (
        composite_tiles_packed_plain,
        tile_blocks,
    )

    worst = 0.0
    small = gt.RenderConfig(height=600, width=800)
    cam = look_camera(gt, (-1.5, -1.5, -3.0), 800 / 600, fov=90.0, near=0.3)
    scene = gt.make_random_scene(20000, seed=0, device=DEVICE)
    wide = gt.make_random_scene(
        20000, seed=0, scale_range=(0.05, 0.5), device=DEVICE
    )
    cases = (
        ("800x600", scene, dict(), ("r", "g", "b")),
        ("800x600 alpha+depth+bg", scene,
         dict(output_alpha=True, output_depth=True, background=(0.2, 0.4, 0.8)),
         ("r", "g", "b", "alpha", "depth")),
        ("800x600 wide splats", wide, dict(), ("r", "g", "b")),
    )
    for name, sc, extra, rows in cases:
        cfg = gt.RenderConfig(height=small.height, width=small.width, **extra)
        out_alpha = cfg.output_alpha or cfg.background is not None
        inst = packed_frame(gt, sc, cam, cfg, cfg.output_depth)
        kw = comp_kwargs(cfg, out_alpha)
        depth = inst.depth_f32 if cfg.output_depth else None
        k_out = gt.composite_tiles_packed(
            inst.packed_feats, inst.tile_start, inst.tile_count, depth_row=depth, **kw
        )
        p_out = composite_tiles_packed_plain(
            inst.packed_feats, inst.tile_start, inst.tile_count, depth_row=depth, **kw
        )
        worst = max(worst, compare(torch, name, k_out, p_out, rows, ("depth",)))
        # The census: the same rows, and every block's lane equal.
        k_out, k_sat = gt.composite_tiles_packed(
            inst.packed_feats, inst.tile_start, inst.tile_count, depth_row=depth,
            with_sat=True, **kw
        )
        p_out, p_sat = composite_tiles_packed_plain(
            inst.packed_feats, inst.tile_start, inst.tile_count, depth_row=depth,
            with_sat=True, **kw
        )
        worst = max(worst, compare(torch, f"{name} with_sat", k_out, p_out, rows,
                                   ("depth",)))
        check_sat(torch, f"{name} with_sat", k_sat, p_sat)

    # 32 tiles of the full 1080p frame: the 16 heaviest and 16 random.
    scene3m, cam3m, cfg3m = big
    inst = packed_frame(gt, scene3m, cam3m, cfg3m, False)
    heavy = torch.topk(inst.tile_count, 16).indices.tolist()
    gen = torch.Generator().manual_seed(0)
    rest = [t for t in torch.randperm(cfg3m.num_tiles, generator=gen).tolist()
            if t not in heavy][:16]
    tiles = heavy + rest
    kw = comp_kwargs(cfg3m, False)
    k_full = gt.composite_tiles_packed(
        inst.packed_feats, inst.tile_start, inst.tile_count, **kw
    )
    k_tiles = tile_blocks(k_full, tiles, tiles_x=cfg3m.tiles_x,
                          tile_w=cfg3m.tile_w, tile_h=cfg3m.tile_h)
    p_tiles = composite_tiles_packed_plain(
        inst.packed_feats, inst.tile_start, inst.tile_count, tiles=tiles, **kw
    )
    # Plain blocks include pixels past the image edge; the kernel writes
    # only in-image pixels, which tile_blocks pads with zeros.
    in_img = tile_blocks(torch.ones_like(k_full[:1]), tiles, tiles_x=cfg3m.tiles_x,
                         tile_w=cfg3m.tile_w, tile_h=cfg3m.tile_h)
    worst = max(worst, compare(
        torch, "1080p 3M: 32 tiles", k_tiles, p_tiles * in_img, ("r", "g", "b")
    ))
    k_full, k_sat = gt.composite_tiles_packed(
        inst.packed_feats, inst.tile_start, inst.tile_count, with_sat=True, **kw
    )
    p_tiles, p_sat = composite_tiles_packed_plain(
        inst.packed_feats, inst.tile_start, inst.tile_count, tiles=tiles,
        with_sat=True, **kw
    )
    k_tiles = tile_blocks(k_full, tiles, tiles_x=cfg3m.tiles_x,
                          tile_w=cfg3m.tile_w, tile_h=cfg3m.tile_h)
    worst = max(worst, compare(torch, "1080p 3M: 32 tiles with_sat", k_tiles,
                               p_tiles * in_img, ("r", "g", "b")))
    n_blk = k_sat.numel() // cfg3m.num_tiles
    sel = torch.as_tensor(tiles, device=DEVICE)
    check_sat(torch, "1080p 3M: 32 tiles with_sat",
              k_sat.view(cfg3m.num_tiles, n_blk)[sel].reshape(-1), p_sat)
    return worst, inst, tiles


def check_sat(torch, name, k_sat, p_sat):
    """The census lanes of kernel and plain version, equal on every block."""
    diff = int((k_sat != p_sat).sum())
    out({"case": name, "sat_blocks": k_sat.numel(), "sat_blocks_differing": diff,
         "sat_blocks_recorded": int((k_sat >= 0).sum())})
    check(k_sat.dtype == torch.int32 and k_sat.shape == p_sat.shape and diff == 0,
          f"{name}: {diff} census blocks differ between kernel and plain version")


def capture_lookups(gt, fn):
    """Runs ``fn()`` with the lookup wrapper recording its inputs as the
    cull (``satcull.rect_cutoff``) and emission (per-position cull) call
    it: {"rect_cutoff" | "per_position": (table, idx, kwargs)}."""
    from gaussianrenderer_tpu_torch.ops import instances, satcull

    seen = {}
    saved = (satcull.table_lookup, instances.table_lookup)

    def recorder(name, wrapped):
        def record(table, idx, **kw):
            seen[name] = (table, idx, kw)
            return wrapped(table, idx, **kw)
        return record

    satcull.table_lookup = recorder("rect_cutoff", saved[0])
    instances.table_lookup = recorder("per_position", saved[1])
    try:
        fn()
    finally:
        satcull.table_lookup, instances.table_lookup = saved
    return seen


def lookup_bound_ms(n, idx_bytes, m):
    """Least time of one lookup on an H100: each index read once, each
    output written once, the table read once, over the HBM rate (it does
    no arithmetic to speak of)."""
    return (n * (idx_bytes + 4) + 4 * m) / PEAK_HBM_BYTES * 1e3


def phase_lookup(torch, gt, big, card):
    """The lookup kernel against its plain version, bit for bit, on the
    inputs bench_3m's culled frames give it, with out-of-range indices,
    and on a 4K pyramid; then its times at the 3M rect_cutoff shape."""
    from gaussianrenderer_tpu_torch.ops import satcull
    from gaussianrenderer_tpu_torch.ops.cuda.lookup import bf16_ceil, table_lookup_plain

    scene, cam, cfg = big
    scfg = dataclasses.replace(cfg, sat_cull=True)
    camp = cam.params(cfg.k_sigma, device=DEVICE)
    init = satcull.initial_cutoff(cfg.tiles_x, cfg.tiles_y, cfg.tile_w, cfg.tile_h,
                                  device=DEVICE)
    _, _, cut1 = gt.render_frame(scene, camp, scfg, sat_state=init)
    seen = capture_lookups(gt, lambda: gt.render_frame(scene, camp, scfg, sat_state=cut1))
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rect_t, rect_i, rect_kw = seen["rect_cutoff"]
    pos_t, pos_i, pos_kw = seen["per_position"]
    m = rect_t.shape[0]
    wild = torch.randint(-(2**31), 2**31 - 1, (65536,), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    near_edge = torch.randint(-64, m + 64, (65536,), generator=gen, device=DEVICE,
                              dtype=torch.int32)
    img4k = torch.nn.functional.interpolate(cut1[None, None], size=GRID_4K,
                                            mode="nearest")[0, 0]
    tab4k = bf16_ceil(satcull.build_pyramid(img4k))
    m4k = tab4k.shape[0]
    idx4k = torch.randint(-64, m4k + 64, (3_000_000,), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    cases = (
        ("1080p pyramid, 3M rect_cutoff indices", rect_t, rect_i, rect_kw),
        ("frame-2 candidate lanes (int64 tile ids)", pos_t, pos_i, pos_kw),
        ("1080p pyramid, out-of-range indices", rect_t, torch.cat([wild, near_edge]),
         rect_kw),
        ("4K pyramid", tab4k, idx4k, dict(r=128 * -(-m4k // 16384), q=128)),
    )
    max_err = 0.0
    for name, table, idx, kw in cases:
        got = gt.table_lookup(table, idx, **kw)
        want = table_lookup_plain(table, idx, **kw)
        diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        out({"case": f"lookup: {name}", "n": idx.numel(), "table_entries": table.numel(),
             "index_dtype": str(idx.dtype), "elements_differing": diff, "max_abs": err})
        check(diff == 0, f"lookup {name}: {diff} outputs differ from the plain version")

    def times(table, idx, kw, reps=20):
        ms = cuda_ms(torch, lambda: gt.table_lookup(table, idx, **kw), reps)
        plain_ms = cuda_ms(torch, lambda: table_lookup_plain(table, idx, **kw), reps)
        tab_r = table.to(torch.bfloat16).to(torch.float32)
        idx_c = torch.clamp(idx.to(torch.int64), 0, table.numel() - 1)
        library_ms = cuda_ms(torch, lambda: torch.take(tab_r, idx_c), reps)
        return {
            "n": idx.numel(), "index_bytes": idx.element_size(), "table_entries": table.numel(),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": lookup_bound_ms(idx.numel(), idx.element_size(), table.numel()),
        }

    res = {"rect_cutoff": times(rect_t, rect_i, rect_kw),
           "per_position": times(pos_t, pos_i, pos_kw), "max_abs_err": max_err,
           "card": card}
    out({"lookup_times": res})
    return res


def phase_goldens(torch, gt):
    import numpy as np

    for name in GOLDEN_NAMES:
        scene, cam, cfg, tv = golden_setup(name)
        fb, stats = gt.render_frame(
            scene, cam.params(cfg.k_sigma, device=DEVICE), cfg, time_value=tv
        )
        golden = np.load(
            os.path.join(REPO, "tests", "fixtures", f"golden_{name}.npz")
        )["framebuffer"]
        fb = fb.cpu().numpy()
        check(fb.shape == golden.shape, f"golden {name}: shape {fb.shape}")
        score = psnr(fb, golden)
        out({"golden": name, "psnr_db": score, "overflow": bool(stats.overflow)})
        check(score >= GOLDEN_MIN_PSNR, f"golden {name}: {score:.2f} dB < 40")


def phase_full(torch, gt, label, setup, card, frames=10):
    """The main path at full width: render_frame on one scene, counts,
    frame and kernel times, kernel launches on the timed run."""
    import numpy as np

    comp = gt.composite_tiles_packed
    scene, cam, cfg = setup
    camp = cam.params(cfg.k_sigma, device=DEVICE)
    comp.launches = gt.table_lookup.launches = 0
    fb, stats = gt.render_frame(scene, camp, cfg)
    torch.cuda.synchronize()
    frame_s, frame_ev_ms = [], []
    for _ in range(frames):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        fb, stats = gt.render_frame(scene, camp, cfg)
        e1.record()
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        frame_ev_ms.append(e0.elapsed_time(e1))
    launches = comp.launches
    lookup_launches = gt.table_lookup.launches

    img = fb.cpu().numpy()
    check(img.shape == (3, cfg.height, cfg.width), f"{label}: shape {img.shape}")
    check(np.isfinite(img).all(), f"{label}: non-finite pixels")
    check(not bool(stats.overflow), f"{label}: overflow")
    check(launches == frames + 1, f"{label}: {launches} kernel launches")
    check(lookup_launches == 0, f"{label}: {lookup_launches} lookups on the unculled path")
    mean = float(img.mean())
    check(0.0 < mean < 1.0, f"{label}: image mean {mean}")

    preprocess, emit = frame_stages(gt, scene, cam, cfg, False)
    proj = preprocess()
    preprocess_ms = cuda_ms(torch, preprocess, frames)
    emission_ms = cuda_ms(torch, lambda: emit(proj), frames)
    inst = emit(proj)
    kw = comp_kwargs(cfg, False)
    walked = torch.zeros(cfg.num_tiles, dtype=torch.int32, device=DEVICE)
    comp(inst.packed_feats, inst.tile_start, inst.tile_count,
         chunks_walked=walked, **kw)
    kernel_ms = cuda_ms(torch, lambda: comp(
        inst.packed_feats, inst.tile_start, inst.tile_count, **kw), frames)
    bound_ms, bound_by, pairs, in_box = compositor_bound_ms(
        torch, inst, cfg, walked, 3
    )
    counts = {"num_instances": int(stats.num_instances),
              "num_culled": int(stats.num_culled)}
    res = {
        "frame": label,
        "gaussians": scene.num_gaussians,
        "resolution": f"{cfg.width}x{cfg.height}",
        **counts,
        "overflow": bool(stats.overflow),
        "center_clipped": bool(stats.center_clipped),
        "jax_counts": REF_COUNTS[label],
        "image_mean": mean,
        "frame_ms_median": 1e3 * statistics.median(frame_s),
        "frame_ms_median_cuda_events": statistics.median(frame_ev_ms),
        "frame_ms_all": [1e3 * t for t in frame_s],
        "kernel_ms_median": kernel_ms,
        "preprocess_ms_median": preprocess_ms,
        "emission_sort_ms_median": emission_ms,
        "kernel_launches": launches,
        "pairs_walked": pairs,
        "pairs_in_aabb": in_box,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "card": card,
    }
    out(res)
    check(counts == REF_COUNTS[label],
          f"{label}: counts {counts} differ from the JAX package's {REF_COUNTS[label]}")
    return res, inst


def phase_profile(torch, label, render_once, card, frame_ms, frames=3):
    """torch.profiler over a few frames (``render_once()`` each): the
    device's busy time per frame (summed kernel time), its share of
    ``frame_ms`` (the unprofiled median frame), and where the device time
    goes, by kernel and by PyTorch op. The profiled wall time is printed
    too; it carries the profiler's own overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    render_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            render_once()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / frames

    def dev_ms(e, self_only):
        name = "self_device_time_total" if self_only else "device_time_total"
        if not hasattr(e, name):
            name = name.replace("device", "cuda")
        return getattr(e, name) / 1e3 / frames

    events = prof.key_averages()
    kernels = sorted(
        (e for e in events if e.device_type == DeviceType.CUDA),
        key=lambda e: -dev_ms(e, True),
    )
    busy_ms = sum(dev_ms(e, True) for e in kernels)
    ops = sorted(
        (e for e in events
         if e.device_type == DeviceType.CPU and e.key.startswith("aten::")),
        key=lambda e: -dev_ms(e, False),
    )
    out({
        "profile": label,
        "wall_ms_per_frame_profiled": wall_ms,
        "device_busy_ms_per_frame": busy_ms if busy_ms > 0 else "not measured",
        "device_busy_share_of_unprofiled_frame":
            busy_ms / frame_ms if busy_ms > 0 else "not measured",
        "top_kernels_ms": [[e.key[:70], dev_ms(e, True)] for e in kernels[:8]],
        "top_aten_ops_device_ms": [[e.key, dev_ms(e, False)] for e in ops[:10]],
        "card": card,
    })


def psnr_t(a, b):
    """PSNR (peak 1) of two tensors on the card; "inf" when equal."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return "inf" if mse == 0 else 10.0 * math.log10(1.0 / mse)


def orbit_poses(cam, cfg, step_deg, frames):
    """Camera params of ``frames`` poses orbiting ``step_deg`` per frame
    from ``cam`` (which is left as it is)."""
    c = copy.deepcopy(cam)
    poses = []
    for _ in range(frames):
        c.orbit(step_deg, 0.0)
        c.update_camera_matrices()
        poses.append(c.params(cfg.k_sigma, device=DEVICE))
    return poses


def host_ms(torch, fn):
    """(result, ms) of ``fn()`` on the host clock, the card synchronized
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def phase_session(torch, gt, label, setup, card, frames=10):
    """The culled session's main path: ``make_renderer(sat_cull=True)``
    at full width. Unculled references of every pose are rendered first;
    then the kernels' counts are set to 0, the session renders frame 1,
    frame 2 at the same pose and an orbit of ``frames`` at 3°/frame, and
    the counts are read. Then an ungated 5°/frame orbit, and CUDA-event
    stage times of a culled frame."""
    from gaussianrenderer_tpu_torch import render as prender
    from gaussianrenderer_tpu_torch.ops import satcull

    scene, cam, cfg = setup
    scfg = dataclasses.replace(cfg, sat_cull=True)
    comp, look = gt.composite_tiles_packed, gt.table_lookup
    p0 = cam.params(cfg.k_sigma, device=DEVICE)
    poses3 = orbit_poses(cam, cfg, ORBIT_DEG, frames)
    poses5 = orbit_poses(cam, cfg, BENCH_ORBIT_DEG, frames)

    gt.render_frame(scene, p0, cfg)  # warm-up
    ref0, ref_st = gt.render_frame(scene, p0, cfg)
    refs3, unculled_ms = [], []
    for p in poses3:
        (fb, _), ms = host_ms(torch, lambda: gt.render_frame(scene, p, cfg))
        refs3.append(fb)
        unculled_ms.append(ms)
    refs5 = [gt.render_frame(scene, p, cfg)[0] for p in poses5]

    render = gt.make_renderer(scene, scfg)
    comp.launches = look.launches = 0
    (fb1, st1), ms1 = host_ms(torch, lambda: render(p0))
    (fb2, st2), ms2 = host_ms(torch, lambda: render(p0))
    orbit = []
    for p in poses3:
        (fb, st), ms = host_ms(torch, lambda: render(p))
        orbit.append((fb, st, ms))
    launches = {"tile_render2": comp.launches, "lookup": look.launches}
    n_frames = 2 + frames

    # Checks of the counted run.
    check(launches == {"tile_render2": n_frames, "lookup": 2 * n_frames},
          f"{label} session: kernel launches {launches} in {n_frames} frames")
    check(fb1.shape == (3, cfg.height, cfg.width) and bool(torch.isfinite(fb1).all()),
          f"{label} session: frame 1 shape {tuple(fb1.shape)} or non-finite pixels")
    check(int(st1.sat_culled) == 0, f"{label}: frame 1 culled {int(st1.sat_culled)}")
    counts1 = {"num_instances": int(st1.num_instances), "num_culled": int(st1.num_culled)}
    check(counts1 == REF_COUNTS[label],
          f"{label}: frame 1 counts {counts1} differ from {REF_COUNTS[label]}")
    check(torch.equal(fb1, ref0), f"{label}: frame 1 differs from the unculled frame")
    err2 = float((fb2 - ref0).abs().max())
    frame2 = {"sat_culled": int(st2.sat_culled), "num_instances": int(st2.num_instances),
              "sat_risk": int(st2.sat_risk), "num_culled": int(st2.num_culled),
              "max_abs_vs_unculled": err2}
    check(frame2["sat_risk"] == 0, f"{label}: frame 2 sat_risk {frame2['sat_risk']}")
    check(frame2["sat_culled"] > 0, f"{label}: frame 2 culled nothing")
    check(err2 <= SAT_EXACT_ATOL, f"{label}: frame 2 max |fb − unculled| {err2:.3g}")
    psnr3 = [psnr_t(fb, ref) for (fb, _, _), ref in zip(orbit, refs3)]
    for i, v in enumerate(psnr3):
        check(v == "inf" or v >= ORBIT_MIN_PSNR,
              f"{label}: orbit frame {i + 1} at {ORBIT_DEG}°/frame: {v} dB")

    render5 = gt.make_renderer(scene, scfg)
    render5(p0)
    psnr5 = []
    for p, ref in zip(poses5, refs5):
        fb, _ = render5(p)
        psnr5.append(psnr_t(fb, ref))

    # Stage times of a culled frame: the same-pose frame 2.
    init = satcull.initial_cutoff(cfg.tiles_x, cfg.tiles_y, cfg.tile_w, cfg.tile_h,
                                  device=DEVICE)
    _, _, cut1 = gt.render_frame(scene, p0, scfg, sat_state=init)
    preprocess, _ = frame_stages(gt, scene, cam, cfg, False)
    geo = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
               tile_h=cfg.tile_h)
    proj = preprocess()
    proj_c, _, cut_q = prender._sat_cull(proj, p0, scfg, cut1)

    def emit():
        return gt.build_packed_instances(proj_c, near=p0.near, far=p0.far, want_depth=True,
                                         sat_cut_q=cut_q, **geo)

    inst = emit()
    kw = comp_kwargs(cfg, False)
    _, sat_idx = comp(inst.packed_feats, inst.tile_start, inst.tile_count, with_sat=True,
                      **kw)
    walked = torch.zeros(cfg.num_tiles, dtype=torch.int32, device=DEVICE)
    comp(inst.packed_feats, inst.tile_start, inst.tile_count, chunks_walked=walked, **kw)
    bound_ms, bound_by, _, _ = compositor_bound_ms(torch, inst, cfg, walked, 3)
    sy, sx = satcull.sat_grid(cfg.tiles_x, cfg.tiles_y, cfg.tile_w, cfg.tile_h)
    eff = satcull.dilate_cutoff(cut1, scfg.sat_dilate)
    table = satcull.build_pyramid(eff)
    step = (p0.far - p0.near) / float((1 << min(32 - cfg.num_tiles.bit_length(), 24)) - 1)
    stages = {
        "projection": cuda_ms(torch, preprocess, frames),
        "cull": cuda_ms(torch, lambda: prender._sat_cull(proj, p0, scfg, cut1), frames),
        "cull_part_dilate_pyramid": cuda_ms(torch, lambda: satcull.build_pyramid(
            satcull.dilate_cutoff(cut1, scfg.sat_dilate)), frames),
        "cull_part_rect_cutoff": cuda_ms(torch, lambda: satcull.rect_cutoff(
            table, proj.aabb_px, sx=sx, sy=sy), frames),
        "cull_part_tile_cutoff_q": cuda_ms(torch, lambda: satcull.tile_cutoff_q(
            eff, near=p0.near, depth_step=step, margin=scfg.sat_margin, **geo), frames),
        "emission_sort": cuda_ms(torch, emit, frames),
        "compositor_with_sat": cuda_ms(torch, lambda: comp(
            inst.packed_feats, inst.tile_start, inst.tile_count, with_sat=True, **kw),
            frames),
        "compositor_plain": cuda_ms(torch, lambda: comp(
            inst.packed_feats, inst.tile_start, inst.tile_count, **kw), frames),
        "cutoff_from_sat": cuda_ms(torch, lambda: satcull.cutoff_from_sat(
            sat_idx, inst.depth_f32, **geo), frames),
    }
    orbit_ms = [ms for _, _, ms in orbit]
    # Where a culled frame's time goes: a session at its same-pose frame 2
    # and later (the steady culled state).
    render_p = gt.make_renderer(scene, scfg)
    render_p(p0)
    same_ms = [host_ms(torch, lambda: render_p(p0))[1] for _ in range(frames)]
    phase_profile(torch, f"{label} culled session frame (same pose, frame 2 on)",
                  lambda: render_p(p0), card, statistics.median(same_ms))
    res = {
        "session": label,
        "gaussians": scene.num_gaussians,
        "resolution": f"{cfg.width}x{cfg.height}",
        "frame1": {**counts1, "sat_culled": int(st1.sat_culled), "ms": ms1},
        "frame2_same_pose": {**frame2, "ms": ms2},
        "same_pose_frames_2_on_ms_all": same_ms,
        "tpu_frame2_same_pose": TPU_SAT_FRAME2 if label == "bench_3m" else None,
        "orbit_3deg": {
            "frame_ms_median": statistics.median(orbit_ms),
            "frame_ms_min": min(orbit_ms), "frame_ms_max": max(orbit_ms),
            "frame_ms_all": orbit_ms,
            "unculled_frame_ms_median": statistics.median(unculled_ms),
            "unculled_frame_ms_all": unculled_ms,
            "psnr_db_vs_unculled": psnr3,
            "sat_culled": [int(st.sat_culled) for _, st, _ in orbit],
            "num_instances": [int(st.num_instances) for _, st, _ in orbit],
            "sat_risk": [int(st.sat_risk) for _, st, _ in orbit],
        },
        "orbit_5deg_psnr_db_vs_unculled_ungated": psnr5,
        "culled_frame_stage_ms": stages,
        "culled_frame_compositor_bound_ms": bound_ms,
        "culled_frame_compositor_bound_by": bound_by,
        "kernel_launches": launches,
        "kernel_launches_per_frame": {k: v / n_frames for k, v in launches.items()},
        "card": card,
    }
    out(res)
    return res


# ------------------------------------------------------------------ training
def train_500k_config(gt):
    """The configuration data/trained_500k.ply was fitted with
    (train_scene.jsonl): 640×480, auto 32×32 tiles (20×15), chunk 128,
    SH degree 1, the training compositor."""
    return gt.RenderConfig(height=TRAIN_H, width=TRAIN_W, sh_degree=1, compositor="diff")


def train_poses(gt, cfg):
    """TRAIN_POSES views on the fitting orbit (radius 5.5, fov 60°,
    tools/make_trained_scene.py) at height 1.7, from (3.9, 1.7, 3.9)
    in TRAIN_POSE_DEG steps."""
    cams = []
    for i in range(TRAIN_POSES):
        ang = math.radians(45.0 + TRAIN_POSE_DEG * i)
        pos = (5.5 * math.sin(ang), 1.7, 5.5 * math.cos(ang))
        cam = look_camera(gt, pos, cfg.width / cfg.height, fov=60.0)
        cams.append(cam.params(cfg.k_sigma, device=DEVICE))
    return cams


def perturbed(torch, gt, truth):
    """The fitted params with seeded position noise (σ 0.01) and
    opacity shrunk (logit − 1)."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    noise = torch.randn(truth.positions.shape, generator=gen, device=DEVICE)
    return truth._replace(positions=truth.positions + 0.01 * noise,
                          raw_opacity=truth.raw_opacity - 1.0)


def train_inputs(gt, params, camp, cfg):
    """The training compositor's inputs for one view: (sorted features,
    assignment), as render_for_training builds them."""
    from gaussianrenderer_tpu_torch.ops.compositing import gather_sorted_features_seg

    proj = gt.preprocess_gaussians(
        params.to_scene(), camp, width=cfg.width, height=cfg.height,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
        sh_degree=cfg.sh_degree, quantize_centers=False,
    )
    asg = gt.build_sorted_instances(proj, tiles_x=cfg.tiles_x, num_tiles=cfg.num_tiles,
                                    near=camp.near, far=camp.far)
    sf = gather_sorted_features_seg(gt.build_features(proj), asg, cfg.chunk_size)
    return sf, asg


def heavy_overdraw_inputs(gt):
    """tests/test_train_kernel.py's heavy-overdraw case at 4× the splats
    and 256×256 (tiles of over 20 chunks, saturation, the 0.99 clamp)."""
    import torch

    scene = gt.make_random_scene(16000, seed=11, extent=0.8, scale_range=(0.2, 0.6),
                                 device=DEVICE)
    scene = scene._replace(opacity=torch.clamp(scene.opacity * 4.0, 0.0, 1.0))
    cfg = gt.RenderConfig(height=256, width=256, compositor="diff")
    camp = look_camera(gt, (0.0, 0.0, 2.5), 1.0, fov=70.0).params(3.0, device=DEVICE)
    sf, asg = train_inputs(gt, gt.SceneParams.from_scene(scene), camp, cfg)
    check(int(asg.tile_count.max()) > 20 * cfg.chunk_size,
          "heavy-overdraw case: no tile has over 20 chunks")
    return sf, asg, cfg


def train_kw(cfg):
    return dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
                tile_h=cfg.tile_h, chunk=cfg.chunk_size)


def train_pairs(torch, sf, asg, cfg, stats, chk, off):
    """One frame's (in-image pixel, walked lane) pairs by the work the
    function needs, recomputed from the plain forward's stats and
    checkpoints: lanes inside their tile's range, chunks before the tile's
    exit (i_end), pixels inside the image. A pair is live while its
    pixel's t_before ≥ 1e-3. Returns a dict: ``walked`` (all such pairs),
    ``in_aabb`` (of those, inside the lane's AABB), and the live pairs
    ``live_outside`` (outside the AABB), ``live_faint`` (inside, alpha
    below 1e-3) and ``live_weighted`` (inside and weighted)."""
    from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt

    k = cfg.chunk_size
    i64 = torch.int64
    dev = sf.device
    p = cfg.tile_w * cfg.tile_h
    i_end_all = stats.reshape(tt.STATS_ROWS, cfg.num_tiles, p)[4, :, 0].to(i64)
    lane = torch.arange(k, device=dev)
    keys = ("walked", "in_aabb", "live_outside", "live_faint", "live_weighted")
    sums = torch.zeros(len(keys), dtype=i64, device=dev)
    for b0 in range(0, cfg.num_tiles, tt.TILE_BATCH):
        tb = torch.arange(b0, min(b0 + tt.TILE_BATCH, cfg.num_tiles), device=dev)
        start = asg.tile_start[tb].to(i64)
        end = start + asg.tile_count[tb].to(i64)
        aligned = (start // k) * k
        off_b = off[tb].to(i64)
        i_end = i_end_all[tb]
        px, py = tt._pixels(tb, cfg.tiles_x, cfg.tile_w, cfg.tile_h)
        in_image = (px < cfg.width) & (py < cfg.height)  # (nb, P, 1)
        for ci in range(int(i_end.max())):
            active = ci < i_end
            t_carry = chk[torch.where(active, off_b + ci, 0)]
            slot = aligned[:, None] + ci * k + lane[None, :]
            valid = (slot >= start[:, None]) & (slot < end[:, None]) & active[:, None]
            alpha, aux = tt._chunk_terms(sf, slot, valid, px, py)
            _, _, gate, _ = tt._chunk_recompute(alpha, t_carry)
            pair = in_image & valid[:, None, :]
            live = pair & gate
            inside = aux["inside"]
            sums += torch.stack([
                pair.sum(), (pair & inside).sum(), (live & ~inside).sum(),
                (live & inside & ~aux["mask"]).sum(), (live & aux["mask"]).sum(),
            ])
    return dict(zip(keys, (int(v) for v in sums.tolist())))


def train_bound_ms(sf, cfg, pairs, n_chk, backward):
    """Least time of one train-kernel launch on an H100: the larger of
    the operations this frame's data needs over the fp32 peak and the
    bytes the function must move over the HBM peak.

    Operations: each live pair of :func:`train_pairs` at its
    ``OPS_TRAIN_*`` cost (weighted pairs ``OPS_TRAIN_FWD`` forward or
    ``OPS_TRAIN_BWD`` backward); pairs past their pixel's stop and pixels
    past the image edge cost nothing. Bytes: the (C+K, 16) features,
    ranges and checkpoint offsets in, stats and checkpoints out (forward);
    features, cotangent rows, stats, checkpoints and ranges in, the
    gradient rows out (backward). Returns (ms, "operations" | "bytes")."""
    from gaussianrenderer_tpu_torch.ops.cuda.tile_train import STATS_ROWS

    p = cfg.tile_w * cfg.tile_h
    ops = (pairs["live_weighted"] * (OPS_TRAIN_BWD if backward else OPS_TRAIN_FWD)
           + pairs["live_faint"] * OPS_TRAIN_ALPHA
           + pairs["live_outside"] * OPS_TRAIN_BOX_TEST)
    tp = cfg.num_tiles * p
    n_bytes = sf.numel() * 4 + 12 * cfg.num_tiles + 4 * n_chk * p + 4 * STATS_ROWS * tp
    if backward:
        n_bytes += 4 * STATS_ROWS * tp + sf.numel() * 4
    ops_s, bytes_s = ops / PEAK_FP32_FLOPS, n_bytes / PEAK_HBM_BYTES
    if ops_s >= bytes_s:
        return ops_s * 1e3, "operations"
    return bytes_s * 1e3, "bytes"


def walked_rows(torch, off, i_end_a, i_end_b):
    """Checkpoint rows that both forwards wrote: each tile's first
    min(i_end) rows from its offset."""
    n = torch.minimum(i_end_a, i_end_b).to(torch.int64)
    first = torch.repeat_interleave(off.to(torch.int64), n)
    rank = torch.arange(first.numel(), device=n.device) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    return first + rank


def grad_rel(d, ref):
    """Per gradient column: max |d − ref| over max |ref|."""
    rel = {}
    for col, key in enumerate(("cx", "cy", "A", "B", "C", "op", "r", "g", "b")):
        scale = float(ref[:, col].abs().max())
        rel[key] = float((d[:, col] - ref[:, col]).abs().max()) / max(scale, 1e-30)
    return rel


def compare_train(torch, name, sf, asg, cfg):
    """Both train kernels against their plain versions on one frame's
    inputs (every tile). Forward: the rgb and T rows and the checkpoints
    of the chunks both walked (max |Δ|). Backward, per gradient column
    (max |Δ| / max |plain|), from one cotangent: the backward kernel
    against the plain backward on the kernel forward's stats and
    checkpoints, and the whole kernel chain against the whole plain chain
    (the plain backward on the plain forward's own). Columns 9–15 and the
    lanes past the last tile exactly 0."""
    from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt

    kw = train_kw(cfg)
    off, n_chk = tt.chunk_offsets(asg.tile_start, asg.tile_count, cfg.chunk_size)
    args = (sf, asg.tile_start, asg.tile_count, off)
    stats_k, chk_k = tt.train_forward(*args, n_chk, **kw)
    stats_p, chk_p = tt.train_forward_plain(*args, n_chk, **kw)
    fwd_err = float((stats_k[:4] - stats_p[:4]).abs().max())
    i_end_k = stats_k[4].reshape(cfg.num_tiles, -1)[:, 0]
    i_end_p = stats_p[4].reshape(cfg.num_tiles, -1)[:, 0]
    tiles_exit_differs = int((stats_k[4] != stats_p[4]).reshape(cfg.num_tiles, -1)
                             .any(1).sum())
    rows = walked_rows(torch, off, i_end_k, i_end_p)
    chk_err = float((chk_k[rows] - chk_p[rows]).abs().max()) if rows.numel() else 0.0
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    gout = torch.randn(stats_k.shape, generator=gen, device=DEVICE)
    gout[4:] = 0.0
    d_k = tt.train_backward(*args, gout, stats_k, chk_k, **kw)
    d_p = tt.train_backward_plain(*args, gout, stats_k, chk_k, **kw)
    d_chain = tt.train_backward_plain(*args, gout, stats_p, chk_p, **kw)
    rel = grad_rel(d_k, d_p)
    chain_rel = grad_rel(d_k, d_chain)
    bwd_abs = float((d_k[:, :9] - d_p[:, :9]).abs().max())
    end = int(asg.tile_start[-1] + asg.tile_count[-1])
    rest_zero = float(d_k[:, 9:].abs().max()) == 0.0 and float(d_k[end:].abs().max()) == 0.0
    res = {"case": f"train kernels: {name}", "instances": int(asg.total_instances),
           "max_tile_count": int(asg.tile_count.max()),
           "max_chunks_walked": int(i_end_k.max()), "checkpoint_rows": n_chk,
           "checkpoint_rows_compared": int(rows.numel()),
           "fwd_max_abs": fwd_err, "checkpoint_max_abs": chk_err,
           "tiles_exit_differs": tiles_exit_differs,
           "bwd_max_abs": bwd_abs, "bwd_rel_per_column": rel,
           "chain_rel_per_column": chain_rel,
           "rows_9_15_and_pad_zero": rest_zero}
    out(res)
    check(math.isfinite(fwd_err) and fwd_err <= TRAIN_FWD_MAX_ABS,
          f"{name}: forward kernel vs plain max {fwd_err:.3g}")
    check(math.isfinite(chk_err) and chk_err <= TRAIN_FWD_MAX_ABS,
          f"{name}: forward kernel's checkpoints vs plain max {chk_err:.3g}")
    for label, per_col in (("backward kernel", rel), ("kernel chain", chain_rel)):
        for key, v in per_col.items():
            check(math.isfinite(v) and v <= TRAIN_GRAD_REL,
                  f"{name}: {label} vs plain, column {key}: relative {v:.3g}")
    check(rest_zero, f"{name}: gradient outside columns 0-8 or past the last lane")
    return (max(fwd_err, chk_err), (bwd_abs, max(max(rel.values()), max(chain_rel.values()))),
            (stats_k, chk_k, off, n_chk, gout, stats_p, chk_p))


def phase_train_kernel_vs_plain(torch, gt, frame):
    """The train kernels against their plain versions: the train-500k
    frame's first step (pose 0, perturbed params) and the heavy-overdraw
    case; then the kernels' and plain versions' times on the former."""
    from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt

    sf, asg, cfg = frame
    fwd_err, bwd_err, (stats, chk, off, n_chk, gout, stats_p, chk_p) = compare_train(
        torch, f"trained_500k {cfg.width}x{cfg.height}, first step", sf, asg, cfg)
    heavy = heavy_overdraw_inputs(gt)
    h_fwd, h_bwd, _ = compare_train(
        torch, f"heavy overdraw {heavy[2].width}x{heavy[2].height}", *heavy)
    kw = train_kw(cfg)
    args = (sf, asg.tile_start, asg.tile_count, off)
    times = {
        "fwd_ms": cuda_ms(torch, lambda: tt.train_forward(*args, n_chk, **kw), 10),
        "bwd_ms": cuda_ms(torch, lambda: tt.train_backward(*args, gout, stats, chk, **kw),
                          10),
        "fwd_plain_ms": cuda_ms(torch, lambda: tt.train_forward_plain(*args, n_chk, **kw),
                                1),
        "bwd_plain_ms": cuda_ms(torch, lambda: tt.train_backward_plain(
            *args, gout, stats, chk, **kw), 1),
    }
    pairs = train_pairs(torch, sf, asg, cfg, stats_p, chk_p, off)
    fb_ms, fb_by = train_bound_ms(sf, cfg, pairs, n_chk, False)
    bb_ms, bb_by = train_bound_ms(sf, cfg, pairs, n_chk, True)
    res = {"train_kernel_times": {
        **times, "fwd_bound_ms": fb_ms, "fwd_bound_by": fb_by, "bwd_bound_ms": bb_ms,
        "bwd_bound_by": bb_by, **{f"pairs_{key}": v for key, v in pairs.items()},
        "instances": int(asg.total_instances), "checkpoint_rows": n_chk,
        "fwd_max_abs_err": max(fwd_err, h_fwd), "bwd_max_abs_err": max(bwd_err[0], h_bwd[0]),
        "bwd_max_rel_err": max(bwd_err[1], h_bwd[1]),
    }}
    out(res)
    return res["train_kernel_times"]


def grads_finite(torch, gt, params, camp, target, cfg):
    leaves = gt.SceneParams(*(None if p is None else p.detach().requires_grad_(True)
                              for p in params))
    loss = gt.l1_dssim_loss(leaves, camp, target, cfg)
    grads = torch.autograd.grad(loss, [p for p in leaves if p is not None])
    return all(bool(torch.isfinite(g).all()) for g in grads)


def phase_train(torch, gt, scene, card):
    """The training main path at full width: make_train_step with the
    3DGS optimizer and l1_dssim_loss on data/trained_500k.ply at 640×480,
    TRAIN_STEPS steps cycling TRAIN_POSES views whose targets are the
    fitted params' own renders, from a seeded perturbation. Counts of
    both train kernels are set to 0 just before the steps and read just
    after. Then CUDA-event stage times of one step."""
    from gaussianrenderer_tpu_torch.ops.compositing import gather_sorted_features_seg
    from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt
    from gaussianrenderer_tpu_torch.train import apply_updates

    cfg = train_500k_config(gt)
    cams = train_poses(gt, cfg)
    truth = gt.SceneParams.from_scene(scene)
    with torch.no_grad():
        targets = [gt.render_for_training(truth, c, cfg) for c in cams]
    params0 = perturbed(torch, gt, truth)
    with torch.no_grad():
        psnr_before = [psnr_t(gt.render_for_training(params0, c, cfg), t)
                       for c, t in zip(cams, targets)]
    check(grads_finite(torch, gt, params0, cams[0], targets[0], cfg),
          "train-500k: non-finite gradient at the first step")
    opt = gt.make_3dgs_optimizer()
    step, _ = gt.make_train_step(cfg, optimizer=opt, loss_fn=gt.l1_dssim_loss)
    # Warm-up on a copy (the first call of each op pays its setup).
    step(params0, opt.init(params0), cams[0], targets[0])

    params, state = params0, opt.init(params0)
    losses, step_ms = [], []
    tt.train_forward.launches = tt.train_backward.launches = 0
    for s in range(TRAIN_STEPS):
        i = s % TRAIN_POSES
        (params, state, loss), ms = host_ms(
            torch, lambda: step(params, state, cams[i], targets[i]))
        losses.append(float(loss))
        step_ms.append(ms)
    launches = {"tile_train_fwd": tt.train_forward.launches,
                "tile_train_bwd": tt.train_backward.launches}

    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(all(math.isfinite(v) for v in losses), f"train-500k: non-finite loss {losses}")
    check(last < first, f"train-500k: loss did not fall ({first:.5g} → {last:.5g})")
    check(launches == {"tile_train_fwd": TRAIN_STEPS, "tile_train_bwd": TRAIN_STEPS},
          f"train-500k: kernel launches {launches} in {TRAIN_STEPS} steps")
    # The file holds a few splats with NaN parameters (never valid, zero
    # gradient): every parameter that was finite must stay finite.
    check(all(bool(torch.isfinite(p)[torch.isfinite(p0)].all())
              for p, p0 in zip(params, params0) if p is not None),
          "train-500k: a finite parameter became non-finite")
    check(grads_finite(torch, gt, params, cams[0], targets[0], cfg),
          "train-500k: non-finite gradient after the steps")
    with torch.no_grad():
        psnr_after = [psnr_t(gt.render_for_training(params, c, cfg), t)
                      for c, t in zip(cams, targets)]

    # Stage times of one step at pose 0 from the perturbed params.
    camp, target = cams[0], targets[0]
    leaves = gt.SceneParams(*(None if p is None else p.detach().requires_grad_(True)
                              for p in params0))
    preprocess = lambda: gt.preprocess_gaussians(  # noqa: E731
        leaves.to_scene(), camp, width=cfg.width, height=cfg.height,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h, tiles_x=cfg.tiles_x,
        tiles_y=cfg.tiles_y, sh_degree=cfg.sh_degree, quantize_centers=False)
    proj = preprocess()

    def tiling_gather():
        asg = gt.build_sorted_instances(proj, tiles_x=cfg.tiles_x,
                                        num_tiles=cfg.num_tiles, near=camp.near,
                                        far=camp.far)
        return gather_sorted_features_seg(gt.build_features(proj), asg, cfg.chunk_size), asg

    sf, asg = tiling_gather()
    sfd = sf.detach()
    kw = train_kw(cfg)
    off, n_chk = tt.chunk_offsets(asg.tile_start, asg.tile_count, cfg.chunk_size)
    args = (sfd, asg.tile_start, asg.tile_count, off)
    stats, chk = tt.train_forward(*args, n_chk, **kw)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    gout = torch.randn(stats.shape, generator=gen, device=DEVICE)
    gout[4:] = 0.0

    def backward_ms():
        p = gt.SceneParams(*(None if x is None else x.detach().requires_grad_(True)
                             for x in params0))
        loss = gt.l1_dssim_loss(p, camp, target, cfg)
        live = [x for x in p if x is not None]
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.autograd.grad(loss, live)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    def forward_loss():
        return gt.l1_dssim_loss(leaves, camp, target, cfg)

    grads = torch.autograd.grad(forward_loss(), [x for x in leaves if x is not None])
    grads = iter(grads)
    gtree = gt.SceneParams(*(None if x is None else next(grads) for x in leaves))
    st0 = opt.init(params0)
    reps = 5
    backward_all = statistics.median(backward_ms() for _ in range(reps))
    bwd_kernel = cuda_ms(torch, lambda: tt.train_backward(*args, gout, stats, chk, **kw),
                         reps)
    stages = {
        "projection": cuda_ms(torch, preprocess, reps),
        "tiling_gather": cuda_ms(torch, tiling_gather, reps),
        "forward_kernel": cuda_ms(torch, lambda: tt.train_forward(*args, n_chk, **kw),
                                  reps),
        "loss_forward_total": cuda_ms(torch, forward_loss, reps),
        "backward_total": backward_all,
        "backward_kernel": bwd_kernel,
        "backward_rest": backward_all - bwd_kernel,
        "optimizer": cuda_ms(torch, lambda: apply_updates(
            params0, opt.update(gtree, st0, params0)[0]), reps),
    }
    st_p = opt.init(params0)
    phase_profile(torch, "trained_500k train step (l1_dssim, 3DGS Adam)",
                  lambda: step(params0, st_p, camp, target), card,
                  statistics.median(step_ms))
    res = {
        "train": "trained_500k",
        "gaussians": scene.num_gaussians,
        "resolution": f"{cfg.width}x{cfg.height}",
        "tiles": f"{cfg.tiles_x}x{cfg.tiles_y} of {cfg.tile_w}x{cfg.tile_h}",
        "num_instances_first_step": int(asg.total_instances),
        "splats_with_nonfinite_params": int(
            (~torch.isfinite(params0.positions).all(1)).sum()),
        "steps": TRAIN_STEPS,
        "loss_first5_mean": first, "loss_last5_mean": last, "losses": losses,
        "step_ms_median": statistics.median(step_ms), "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "step_ms_all": step_ms,
        "stage_ms": stages,
        "kernel_launches": launches,
        "kernel_launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
        "psnr_db_before": psnr_before, "psnr_db_after": psnr_after,
        "card": card,
    }
    out(res)
    return res


def phase_train_bench(torch, gt, card, steps=10, n=500_000, size=800):
    """tools/train_bench.py's shape: make_random_scene(500k, seed 0,
    extent 4, scales 0.004–0.03) at 800×800, camera (0, 1, 8), Adam(1e-2),
    MSE against the scene's own render; host-clock step times."""
    scene = gt.make_random_scene(n, seed=0, extent=4.0, scale_range=(0.004, 0.03),
                                 device=DEVICE)
    cfg = gt.RenderConfig(height=size, width=size, compositor="diff")
    camp = look_camera(gt, (0.0, 1.0, 8.0), 1.0).params(cfg.k_sigma, device=DEVICE)
    params = gt.SceneParams.from_scene(scene)
    with torch.no_grad():
        target = gt.render_for_training(params, camp, cfg)
    step, opt = gt.make_train_step(cfg, optimizer=gt.make_optimizer(1e-2))
    state = opt.init(params)
    step(params, state, camp, target)
    times, losses = [], []
    for _ in range(steps):
        (params, state, loss), ms = host_ms(torch, lambda: step(params, state, camp, target))
        times.append(ms)
        losses.append(float(loss))
    check(all(math.isfinite(v) for v in losses), f"train-bench-shape: losses {losses}")
    _, st = gt.render_frame(scene, camp, cfg)
    res = {"train_bench_shape": f"{n} random splats, {size}x{size}, Adam(1e-2), MSE",
           "num_instances": int(st.num_instances), "step_ms_median": statistics.median(times),
           "step_ms_min": min(times), "step_ms_max": max(times), "step_ms_all": times,
           "card": card}
    out(res)
    return res


# ------------------------------------------------------------ harness phases
def run_app(mod, argv):
    """``mod.main()`` with ``argv`` as its arguments: (exit code, stdout)."""
    import contextlib
    import io

    saved = sys.argv
    buf = io.StringIO()
    sys.argv = [mod.__name__] + argv
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main()
    finally:
        sys.argv = saved
    return rc, buf.getvalue()


def app_times(text):
    """{name: (ms, TFLOP/s)} of matrix_test's timing lines."""
    res = {}
    for line in text.splitlines():
        parts = line.replace(":", "").split()
        if len(parts) == 5 and parts[2] == "ms" and parts[4] == "TFLOP/s":
            res[parts[0]] = (float(parts[1]), float(parts[3]))
    return res


def gemm_bound_ms(m, n, k):
    """Least time of one (M, K)·(K, N) bf16 product with an f32 output on
    an H100: 2·M·N·K operations at the dense bf16 tensor rate against
    each input read once and the output written once at the HBM rate."""
    ops_ms = 2.0 * m * n * k / PEAK_BF16_FLOPS * 1e3
    bytes_ms = (2 * m * k + 2 * k * n + 4 * m * n) / PEAK_HBM_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def phase_gemm(torch, gt, card, n=GEMM_N):
    """The GEMM harness's path: the port's ``matrix_test`` at N on random
    and on ones inputs (it checks the kernel against ``torch.mm`` and the
    ones closed form itself and exits 0 only if they hold); then the kernel
    against its plain version on the same random inputs, on ones, on the
    edge shape with 8-blocks and on an odd shape with 1-blocks (the
    element-wise load path); kernel, plain and ``torch.mm`` times."""
    from gaussianrenderer_tpu_torch.apps import matrix_test
    from gaussianrenderer_tpu_torch.ops.cuda.matmul import matmul_blocked_plain

    mm = gt.matmul_blocked
    # matrix_test's default blocking (a contract only: the kernel tiles by
    # 128 whatever it is given).
    kw = dict(bm=min(512, n), bn=min(1024, n), bk=min(1024, n))
    blocks = [f"--{k}={v}" for k, v in kw.items()]
    mm.launches = 0
    runs = {}
    for label, extra in (("random", []), ("ones", ["--ones"])):
        rc, text = run_app(matrix_test, ["--n", str(n), "--device", DEVICE] + blocks + extra)
        log(text.rstrip())
        check(rc == 0 and "-> OK" in text, f"matrix_test {label}: exit {rc}: {text!r}")
        runs[label] = {"times": app_times(text), "stdout": text.splitlines()}
    launches = mm.launches

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    a = torch.randn((n, n), generator=gen, dtype=torch.bfloat16, device=DEVICE)
    b = torch.randn((n, n), generator=gen, dtype=torch.bfloat16, device=DEVICE)
    got = mm(a, b, **kw)
    want = matmul_blocked_plain(a, b, **kw)
    lib = torch.mm(a, b, out_dtype=torch.float32)
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    lib_rel = float((lib - want).abs().max()) / scale
    ones = torch.ones((n, n), dtype=torch.bfloat16, device=DEVICE)
    ones_exact = bool(torch.equal(mm(ones, ones, **kw), torch.full((n, n), float(n),
                                                                      device=DEVICE)))
    cases = [{"case": f"gemm {n}^3 random", "max_rel_err": rel,
              "torch_mm_vs_plain_rel_err": lib_rel, "max_abs_err": rel * scale},
             {"case": f"gemm {n}^3 ones", "all_entries_equal_n": ones_exact}]
    for m_, k_, n_, blk in GEMM_EDGE_SHAPES:
        g = torch.Generator(device=DEVICE).manual_seed(m_)
        ea = torch.randn((m_, k_), generator=g, device=DEVICE).to(torch.bfloat16)
        eb = torch.randn((k_, n_), generator=g, device=DEVICE).to(torch.bfloat16)
        ek = mm(ea, eb, bm=blk, bn=blk, bk=blk)
        ep = matmul_blocked_plain(ea, eb, bm=blk, bn=blk, bk=blk)
        erel = float((ek - ep).abs().max()) / float(ep.abs().max())
        cases.append({"case": f"gemm ({m_}, {k_}) x ({k_}, {n_}), blocks {blk}",
                      "max_rel_err": erel})
        check(erel <= GEMM_MAX_REL, f"gemm edge {m_}x{k_}x{n_}: kernel vs plain {erel:.3g}")
    for c in cases:
        out(c)
    check(rel <= GEMM_MAX_REL, f"gemm {n}^3: kernel vs plain {rel:.3g} of the largest entry")
    check(ones_exact, f"gemm {n}^3 ones: an entry differs from {n}")

    reps = 10
    ms = cuda_ms(torch, lambda: mm(a, b, **kw), reps)
    plain_ms = cuda_ms(torch, lambda: matmul_blocked_plain(a, b, **kw), 3)
    library_ms = cuda_ms(torch, lambda: torch.mm(a, b, out_dtype=torch.float32), reps)
    bound_ms, bound_by = gemm_bound_ms(n, n, n)
    flops = 2.0 * n ** 3
    res = {"gemm_times": {
        "shape": f"({n}, {n}) x ({n}, {n}) bf16 -> f32",
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "tflops": flops / ms / 1e9, "library_tflops": flops / library_ms / 1e9,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "matrix_test": {k: v["times"] for k, v in runs.items()},
        "launches": launches, "card": card}}
    out(res)
    res = res["gemm_times"]
    res["max_abs_err"] = rel * scale
    return res


def block_sort_bound_ms(c, run):
    """Least time of one block sort of a (9, C) int64 matrix on an H100:
    each of the 9 int64 words of a column read once and written once (144
    bytes) at the HBM rate, against one compare and 18 selects (the 9 rows
    of both outputs) per pair and substage, log2(run)·(log2(run)+1)/2
    substages over C/2 pairs, at the card's 32-bit rate outside the
    tensor cores (the data sheet's fp32 figure)."""
    log_run = run.bit_length() - 1
    substages = log_run * (log_run + 1) // 2
    bytes_ms = 144.0 * c / PEAK_HBM_BYTES * 1e3
    ops_ms = substages * (c // 2) * OPS_COMPARE_EXCHANGE / PEAK_FP32_FLOPS * 1e3
    bound = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    return bound[0], bound[1], substages


def sort_matrix(torch, c, key_hi, seed):
    """(9, C) int64 of u32 values: keys in [0, key_hi), payloads full-range."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randint(0, 2**32, (9, c), generator=g, device=DEVICE, dtype=torch.int64)
    x[0] = torch.randint(0, key_hi, (c,), generator=g, device=DEVICE, dtype=torch.int64)
    return x


def phase_block_sort(torch, gt, card, c=BLOCK_SORT_C):
    """The block sort's path, ``block_sort_runs`` itself (no app calls it,
    as in the JAX package), at bench_3m's instance count rounded up to the
    run: one call at the default run, launches counted; then the kernel
    bit-equal to its plain version on all 9 rows for random and tie-heavy
    keys at every tested run; kernel, plain and library times."""
    from gaussianrenderer_tpu_torch.ops.cuda.block_sort import block_sort_runs_plain

    bs = gt.block_sort_runs
    x = sort_matrix(torch, c, 2**32, seed=0)
    bs.launches = 0
    y = bs(x)
    torch.cuda.synchronize()
    launches = bs.launches
    check(launches == 1, f"block sort: {launches} launches for one call")
    keys = y[0].view(c // 2048, 2048)
    check(bool((keys[:, 1:] >= keys[:, :-1]).all()), "block sort: a run is not sorted")
    check(int(x[0].max()) >= 2**31, "block sort: no key with the top bit set")

    for run in BLOCK_SORT_RUNS:
        for kind, key_hi in (("random u32", 2**32), ("tie-heavy, keys in [0, 16)", 16)):
            xi = x if (run, key_hi) == (2048, 2**32) else sort_matrix(torch, c, key_hi, run)
            got, want = bs(xi, run=run), block_sort_runs_plain(xi, run=run)
            differ = int((got != want).sum())
            out({"case": f"block sort run {run}, {kind}", "c": c,
                 "elements_differing": differ,
                 "max_abs": float((got - want).abs().max())})
            check(differ == 0, f"block sort run {run} {kind}: {differ} elements differ")

    def library(xi, run):
        kv, perm = torch.sort(xi[0].view(-1, run), dim=1)
        pay = torch.gather(xi[1:].view(8, -1, run), 2, perm.expand(8, -1, -1))
        return kv, pay

    times = {}
    for run in BLOCK_SORT_RUNS:
        bound_ms, bound_by, substages = block_sort_bound_ms(c, run)
        times[run] = {
            "ms": cuda_ms(torch, lambda: bs(x, run=run), 10),
            "plain_ms": cuda_ms(torch, lambda: block_sort_runs_plain(x, run=run), 2),
            "library_ms": cuda_ms(torch, lambda: library(x, run), 10),
            "bound_ms": bound_ms, "bound_by": bound_by, "substages": substages,
        }
    res = {"block_sort_times": {
        "c": c, "shape": f"(9, {c}) u32 as int64, random keys",
        "library_call": "torch.sort along dim 1 of the (C/run, run) key view + "
                        "one torch.gather of the 8 payload rows",
        "runs": times, "launches": launches, "card": card}}
    out(res)
    return res["block_sort_times"]


def phase_sort_harness(torch, gt):
    """The sort harnesses with their defaults on the card: the port's
    ``onesweep`` (exit 0, every size PASS) and ``radix_test`` (exit 0,
    every JSONL record true on its three checks), its JSONL under build/."""
    from gaussianrenderer_tpu_torch.apps import onesweep, radix_test

    rc, text = run_app(onesweep, ["--device", DEVICE])
    last = text.strip().splitlines()[-1]
    check(rc == 0 and last.endswith(" 0 failed"), f"onesweep: exit {rc}, {last!r}")
    path = os.path.join(REPO, "build", "radix_bench_port.jsonl")
    if os.path.exists(path):
        os.remove(path)
    rc, _ = run_app(radix_test, ["--device", DEVICE, "--out", path])
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    check(rc == 0 and recs, f"radix_test: exit {rc}, {len(recs)} records")
    check(all(r["nondecreasing"] and r["matches_oracle"] and r["radix_matches"]
              for r in recs), "radix_test: a record failed its checks")
    top = max(r["N"] for r in recs)
    res = {"sort_harness": {
        "onesweep": last, "radix_test_records": len(recs), "largest_n": top,
        "device_ms_at_largest_n": {r["algo"]: r["device_ms"] for r in recs if r["N"] == top},
        "record_device": {k: recs[0].get(k) for k in ("device", "platform", "torch", "cuda",
                                                  "power_limit")}}}
    out(res)
    return res["sort_harness"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
        return 1
    sys.path.insert(0, REPO)
    import gaussianrenderer_tpu_torch as gt
    from gaussianrenderer_tpu_torch import _build
    from gaussianrenderer_tpu_torch.ops.cuda.tile_render2 import (
        composite_tiles_packed_plain,
    )

    t_start = time.perf_counter()
    with Phase("device", torch):
        card = card_line()
        out({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
             "device_count": torch.cuda.device_count()})

    with Phase("build", torch):
        secs = _build.build_all()
        regs = []
        for name, text in _build.build_logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"ptxas[{name}]: {line.strip()}")
                if "Used" in line and "registers" in line:
                    regs.append(int(line.split("Used")[1].split("registers")[0]))
        out({"build_seconds": secs, "nvcc": _build.find_nvcc(),
             "max_registers_per_thread": max(regs) if regs else None})
        for name in _build.SOURCES:
            _build.load(name)
    # Full-fp32 matrix products (the default, stated): the plain versions'
    # colour sums must not drop to TF32.
    torch.backends.cuda.matmul.allow_tf32 = False

    with Phase("scene-3m", torch):
        big = bench_3m_setup()

    with Phase("kernel-vs-plain", torch):
        max_err, big_inst, tiles = phase_kernel_vs_plain(torch, gt, big)
        lookup_res = phase_lookup(torch, gt, big, card)

    with Phase("goldens", torch):
        phase_goldens(torch, gt)

    with Phase("full-3m", torch):
        res3m, inst3m = phase_full(torch, gt, "bench_3m", big, card)
        cfg = big[2]
        kw = comp_kwargs(cfg, False)
        plain_ms = cuda_ms(torch, lambda: composite_tiles_packed_plain(
            inst3m.packed_feats, inst3m.tile_start, inst3m.tile_count,
            tiles=tiles, **kw), 1)
        # The kernel over the same 32 tiles: every other tile's range empty.
        only = torch.zeros_like(inst3m.tile_count)
        sel = torch.as_tensor(tiles, device=DEVICE)
        only[sel] = inst3m.tile_count[sel]
        kernel_tiles_ms = cuda_ms(torch, lambda: gt.composite_tiles_packed(
            inst3m.packed_feats, inst3m.tile_start, only, **kw), 5)
        out({"tiles": len(tiles), "plain_ms": plain_ms,
             "kernel_ms_same_tiles": kernel_tiles_ms, "card": card})

    with Phase("profile-3m", torch):
        scene, cam, cfg = big
        camp = cam.params(cfg.k_sigma, device=DEVICE)
        phase_profile(torch, "bench_3m render_frame",
                      lambda: gt.render_frame(scene, camp, cfg), card,
                      res3m["frame_ms_median"])

    with Phase("session-3m", torch):
        sess3m = phase_session(torch, gt, "bench_3m", big, card)
    del big, big_inst, inst3m
    torch.cuda.empty_cache()

    with Phase("full-trained-500k", torch):
        setup500 = trained_500k_setup()
        res500, _ = phase_full(torch, gt, "trained_500k", setup500, card)

    with Phase("session-trained-500k", torch):
        sess500 = phase_session(torch, gt, "trained_500k", setup500, card)
    scene500 = setup500[0]
    del setup500
    torch.cuda.empty_cache()

    with Phase("train-kernel-vs-plain", torch):
        tcfg = train_500k_config(gt)
        truth = gt.SceneParams.from_scene(scene500)
        with torch.no_grad():
            sf, asg = train_inputs(gt, perturbed(torch, gt, truth),
                                   train_poses(gt, tcfg)[0], tcfg)
        train_times = phase_train_kernel_vs_plain(torch, gt, (sf, asg, tcfg))
        del sf, asg, truth

    with Phase("train-500k", torch):
        train_res = phase_train(torch, gt, scene500, card)
    del scene500
    torch.cuda.empty_cache()

    with Phase("train-bench-shape", torch):
        bench_res = phase_train_bench(torch, gt, card)

    with Phase("gemm", torch):
        gemm_res = phase_gemm(torch, gt, card)

    with Phase("block-sort", torch):
        sort_res = phase_block_sort(torch, gt, card)
        torch.cuda.empty_cache()

    with Phase("sort-harness", torch):
        phase_sort_harness(torch, gt)

    out({"kernels": [{
        "name": "tile_render2",
        "route": "cuda",
        "source": "gaussianrenderer_tpu_torch/csrc/tile_render2.cu",
        "replaces": "gaussianrenderer_tpu/ops/pallas/tile_render2.py:158",
        "launches": res3m["kernel_launches"],
        "max_abs_err": max_err,
        "ms": res3m["kernel_ms_median"],
        "plain_ms": plain_ms,
        "bound_ms": res3m["bound_ms"],
        "bound_by": res3m["bound_by"],
        "library_ms": None,
        "shape": "3M splats, 1920x1080, 32x32 tiles, chunk 256",
        "plain_scope": f"{len(tiles)} tiles of that frame (no yardstick)",
        "kernel_ms_same_tiles": kernel_tiles_ms,
        "trained_500k": {"ms": res500["kernel_ms_median"],
                         "launches": res500["kernel_launches"],
                         "bound_ms": res500["bound_ms"],
                         "bound_by": res500["bound_by"]},
        "culled_frame_with_sat_ms": sess3m["culled_frame_stage_ms"]["compositor_with_sat"],
        "culled_frame_plain_ms": sess3m["culled_frame_stage_ms"]["compositor_plain"],
        "session_launches": sess3m["kernel_launches"]["tile_render2"],
    }, {
        "name": "lookup",
        "route": "cuda",
        "source": "gaussianrenderer_tpu_torch/csrc/lookup.cu",
        "replaces": "gaussianrenderer_tpu/ops/pallas/lookup.py:58",
        "launches": sess3m["kernel_launches"]["lookup"],
        "max_abs_err": lookup_res["max_abs_err"],
        "ms": lookup_res["rect_cutoff"]["ms"],
        "plain_ms": lookup_res["rect_cutoff"]["plain_ms"],
        "bound_ms": lookup_res["rect_cutoff"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": lookup_res["rect_cutoff"]["library_ms"],
        "shape": (f"{lookup_res['rect_cutoff']['n']} int32 indices into a "
                  f"{lookup_res['rect_cutoff']['table_entries']}-entry pyramid "
                  "(bench_3m rect_cutoff, 1920x1080)"),
        "library_call": "torch.take of the bf16-rounded f32 table, clamped int64 indices",
        "per_position": lookup_res["per_position"],
        "trained_500k_launches": sess500["kernel_launches"]["lookup"],
    }] + [{
        "name": f"tile_train_{kind}",
        "route": "cuda",
        "source": "gaussianrenderer_tpu_torch/csrc/tile_train.cu",
        "replaces": f"gaussianrenderer_tpu/ops/pallas/tile_train.py:{line}",
        "launches": train_res["kernel_launches"][f"tile_train_{kind}"],
        "max_abs_err": train_times[f"{kind}_max_abs_err"],
        "ms": train_times[f"{kind}_ms"],
        "plain_ms": train_times[f"{kind}_plain_ms"],
        "bound_ms": train_times[f"{kind}_bound_ms"],
        "bound_by": train_times[f"{kind}_bound_by"],
        "library_ms": None,
        "shape": (f"trained_500k, {TRAIN_W}x{TRAIN_H}, 32x32 tiles, chunk 128, "
                  f"{train_times['instances']} instances (first training step)"),
        "gradient_max_rel_err": train_times["bwd_max_rel_err"] if kind == "bwd" else None,
        "step_ms_median": train_res["step_ms_median"],
        "bench_shape_step_ms_median": bench_res["step_ms_median"],
    } for kind, line in (("fwd", 154), ("bwd", 295))] + [{
        "name": "matmul",
        "route": "cuda",
        "source": "gaussianrenderer_tpu_torch/csrc/matmul.cu",
        "replaces": "gaussianrenderer_tpu/ops/pallas/matmul.py:22",
        "launches": gemm_res["launches"],
        "max_abs_err": gemm_res["max_abs_err"],
        "ms": gemm_res["ms"],
        "plain_ms": gemm_res["plain_ms"],
        "bound_ms": gemm_res["bound_ms"],
        "bound_by": gemm_res["bound_by"],
        "library_ms": gemm_res["library_ms"],
        "shape": gemm_res["shape"],
        "library_call": "torch.mm(a, b, out_dtype=torch.float32)",
        "launches_in": "two apps/matrix_test runs (random, --ones), N 8192",
    }, {
        "name": "block_sort",
        "route": "cuda",
        "source": "gaussianrenderer_tpu_torch/csrc/block_sort.cu",
        "replaces": "gaussianrenderer_tpu/ops/pallas/block_sort.py:50",
        "launches": sort_res["launches"],
        "max_abs_err": 0.0,
        "ms": sort_res["runs"][2048]["ms"],
        "plain_ms": sort_res["runs"][2048]["plain_ms"],
        "bound_ms": sort_res["runs"][2048]["bound_ms"],
        "bound_by": sort_res["runs"][2048]["bound_by"],
        "library_ms": sort_res["runs"][2048]["library_ms"],
        "shape": f"{sort_res['shape']}, run 2048",
        "library_call": sort_res["library_call"],
        "launches_in": ("one block_sort_runs call (not wired into a render or "
                        "training path, as in the JAX package)"),
    }]})
    log(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s")
    out(card_line())
    out({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
