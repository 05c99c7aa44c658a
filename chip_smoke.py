#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``gaussianrenderer_tpu_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --train-turns PARENT_CHECKOUT [--same-bits]
                                                         (see train_turns)

Needs one CUDA card and the CUDA toolkit (nvcc); builds the port's CUDA
kernels from the sources in this checkout into build/torch_kernels/.
Phases, each ending with ``torch.cuda.synchronize()`` and a line giving
its elapsed seconds:

1. device           — the card's name and power limit (nvidia-smi);
2. build            — nvcc build of every kernel (seconds, registers) and
                      g++ build of the native PLY and points3D.bin readers
                      into build/torch_native/;
3. scene-3m         — the bench.py headline scene (3M splats, Morton order);
4. kernel-vs-plain  — each kernel against its plain PyTorch version on the
                      card: the compositor, without and with its saturation
                      census (``with_sat``), on three 800×600 packed frames
                      (plain rgb; alpha + depth + background; wide splats),
                      a dense 768×512 frame on 64×128 tiles (without and
                      with an alpha row) and on 128×128 tiles with the
                      census (64 blocks), chunks walked equal, and that
                      64×128 grid through ``render_frame``; and 32 tiles
                      of the 3M-splat 1080p frame (the 16 with the most
                      instances, 16 seeded random) without and with an
                      alpha row, chunks walked equal; the table
                      lookup, bit for bit, on the inputs the culled 3M
                      frames give it (the pyramid of frame 1's cutoff
                      image sampled by all 3M splats; frame 2's candidate
                      lanes), with out-of-range indices, on a 4K pyramid
                      (more than 16,384 entries) and a table of
                      kMaxEntries, with a tail (N % 4 != 0) and with int32
                      and int64 index views 16 bytes off alignment; the
                      lookup's event, device-only (torch.profiler) and
                      host enqueue times beside its bound and one
                      ``torch.take``'s;
5. goldens          — the five tests/fixtures/golden_*.npz setups rendered
                      by the port, PSNR ≥ 40 dB against each framebuffer;
6. full-3m, profile-3m, full-trained-500k
                    — the main path through ``render_frame`` at full width:
                      3M splats at 1920×1080 (bench camera) and
                      data/trained_500k.ply at 1920×1080; counts beside
                      the JAX package's recorded ones, median frame, stage
                      and kernel times, and the kernel's launch count; the
                      compositor's bound from the pairs the plain version
                      counts before each pixel's stop (the pair counts);
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
8. multichip-3m    — the multi-device main path (parallel.render_frame_multichip)
                      on bench_3m at 1920×1080, its ranks started by
                      parallel.spawn after the build (no rank runs nvcc) and
                      sharing the one card over gloo: D = 2 on equal strips
                      with each exchange (gather32, gather_q, a2a_q), D = 4
                      on balance_strips_for_scene strips (gather_q, a2a_q)
                      and balance_rects_for_scene rects (a2a_q): every
                      rank's frame within 2e-4 of render_frame on that
                      rank, gather32 on the xla compositor within 2e-5, no
                      overflow, the strips' instances adding up to the
                      single device's, one compositor launch per rank per
                      frame; then a one-rank NCCL group, bit-equal to
                      render_frame. Per rank: synchronized frame ms, each
                      exchange's bytes and ms alone, instances, launches;
9. native-io       — data/trained_500k.ply and data/trained_100k.ply loaded
                      onto the card through the native reader (the
                      default) and the NumPy reader, in turns, each load
                      timed: positions, SH and quaternions bit-equal,
                      opacity and scales within 4 ulp (count and largest
                      printed); one 1920×1080 frame of the native
                      trained_500k and the bench_3m frame, three timed
                      frames of each (the compositor's launches counted over
                      all eight), render.area_histogram equal to each
                      frame's stats.area_hist and render.emission_total to
                      its num_instances, the probes' ms beside the frame's;
                      an ascii and a truncated PLY raise ValueError, and a
                      header the C++ reader would write outside its buffers
                      for (scale_3) loads through the NumPy reader;
10. train-kernel-vs-plain
                    — both training kernels against their plain versions
                      on every tile of the first training step's frame
                      below and of a heavy-overdraw case (16k large splats
                      at 256×256) on 32×32 and on 64×128 tiles (8192
                      pixels): forward rgb and T within 1e-4, the
                      gradient per column within 1e-4 of the plain
                      version's largest, columns 9–15 and the lanes past
                      the last tile exactly 0, two backward launches bit
                      for bit equal; kernel, plain and bound ms,
                      each pass's device ms (torch.profiler) and the
                      kernel launches of one call; the segment sum (the
                      gather's transpose) on that step's gradient rows,
                      by the backward's own call on the assignment's
                      segments (no sort; the segments equal to the
                      stable argsort's) and by the argsort route: the
                      two bit-equal to each other, to the plain version,
                      to the CPU's index_add_ and across two launches;
                      both calls' ms in turns with one index_add_'s, the
                      kernel's device ms, the plain version's and the
                      bound;
11. train-500k       — the training main path: ``make_train_step`` with
                      ``make_3dgs_optimizer`` and ``l1_dssim_loss`` on
                      data/trained_500k.ply at 640×480 (the fitting
                      config), 30 steps over 4 orbit views whose targets
                      are the file's own renders, from a seeded
                      perturbation: loss finite and falling, no NaN
                      gradient, one launch of each kernel (and of the
                      segment sum) per step; from one state, twice: every
                      gradient, the NDC gradient, the loss and a step's
                      params and Adam moments bit for bit equal; step
                      ms, CUDA-event stage ms, PSNR before and after, and
                      a torch.profiler pass over 3 steps;
12. fit-500k        — the fit main path: ``fit_scene`` on the same file,
                      views, start, loss and optimizer, 60 steps with
                      densify episodes at 20 and 40 and checkpoints at 30
                      and 60, then ``evaluate`` on the views: loss finite
                      and falling, episode bookkeeping sane (recycled ≤
                      dead, ≤ 4·eligible), finite parameters stay finite,
                      one forward and one backward train-kernel call a
                      step and one forward per evaluated view, PSNR above
                      the start's; the step-30 checkpoint restores the
                      fit's params bit for bit; the fit run again, and a
                      resume from step 30, repeat its losses, episodes
                      and final params bit for bit;
                      the fit's wall ms per step, the densifying
                      step beside the plain step (10 synchronized steps
                      each, in turns), one ``densify_step`` episode's
                      CUDA-event ms (checked free of host waits) and
                      ``evaluate`` ms per view; one launch of the
                      densify draw an episode;
13. densify-draw    — the densify draw (ops/cuda/prng.py, JAX's
                      threefry2x32, uniform and erf_inv) at (500000, 3):
                      the kernel's bits and uniforms bit-equal to its
                      plain version's on the card and on the CPU, its
                      normals within 4 ulp of both (the differing values
                      counted), two launches bit-equal; the bf16 draw of
                      the GEMM harness at 8192² within a bf16 ulp of its
                      plain version; the kernel's ms and device ms beside
                      the plain version's, torch.randn's (the draw before
                      it) and the bound; fit-500k's first episode, from
                      its inputs, on the card and on the CPU: counts,
                      recycled slots and donors equal, positions and
                      raw_scales within 1e-5 of 1 + |value|, the other
                      leaves and the moments bit-equal;
14. fit-app         — apps/fit on a poses.json dataset of 8 views of the
                      file at 640×480 (.npy targets), refining the PLY
                      for 40 steps with densification, held-out views and
                      checkpoints (exit 0, PSNR lines, a PLY of the same
                      N), again resumed from step 20; apps/train_test with
                      its defaults (exit 0); the dataset is kept for
                      viewer-2m;
15. multichip-train-500k
                    — make_multichip_train_step on data/trained_500k.ply at
                      its fitting config (640×480, 15 tile rows: balanced
                      strips) with 2 ranks sharing the card: the first
                      step's gradients within 1e-3 of the single-device
                      step's (MSE, the 3DGS Adam), 10 steps from the seeded
                      perturbation with losses finite and falling and one
                      forward and one backward train-kernel call per rank
                      per step; then fit_scene(mesh) for 20 steps with
                      checkpoints at 10 and 20, resumed from 10 (losses
                      and params bit for bit), rank 0's last checkpoint read by a
                      single-device load_checkpoint equal to every rank's
                      returned params;
16. formats-2m      — data/trained_2m.gsz (1,999,994 splats) through the
                      port's load_scene onto the card (load timed); 10
                      frames of an orbit at 1920×1080 through
                      render_frame (median frame ms, instances, the
                      compositor's launches); the compositor against its
                      plain version on 32 tiles of the first frame
                      (without and with an alpha row), its ms and bound;
                      the scene saved and reloaded as q16 .gsz, q8 .gsz
                      and .splat (save and load timed), each reload's
                      first frame scored against the original's: q16
                      > 55 dB, .splat > 35 dB at SH degree 0, q8 printed;
17. colmap-fit      — a COLMAP workspace written by save_colmap_workspace
                      from 12 orbit views of data/trained_surface_100k.gsz
                      at 1280×720 and a points3D cloud of 20,000 of its
                      positions and DC colours (read by the native reader
                      and by the Python loop, and so a 10⁶-point file:
                      arrays equal, each read timed); apps/fit with SfM init (the
                      default, checked by its "SfM init:" line), 100,000
                      splats, 60 steps, densify every 20, every 4th view
                      held out; apps/eval of the fitted PLY through the
                      train and the packed path (exit 0, finite PSNR,
                      overflow_views 0); apps/edit to a pruned .gsz
                      (--min-opacity 0.005) and apps/eval of it; each
                      app's wall time and the kernels' launches in them;
18. blender-fit     — a NeRF-synthetic capture: transforms_train.json (12
                      views) and transforms_test.json (4) with RGBA PNGs
                      of the same scene at 800×800 (alpha from the
                      render's alpha row, camera_angle_x); apps/fit
                      refining the scene (--init, --background white, 40
                      steps) and apps/eval of the test split over white
                      (exit 0, finite PSNR);
19. viewer-2m       — the viewer on the card: viewer.Canvas at 1920×1080
                      with a prewarm (its thread ends without an error)
                      and data/trained_2m.gsz loaded by load_gaussians
                      at formats-2m's pose; its frame bit-equal to
                      render_frame's with equal instances, one
                      compositor launch a frame, a synchronized median
                      of 10 frames; the browser viewer (make_server on
                      a free localhost port): the page, /frame?fmt=png
                      equal to draw(), 10 timed /frame requests (stage
                      medians from /stats, the draw split into the
                      card's tail after render(), the conversion, the
                      copy and the host's flip), a 30-part /stream while /orbit is
                      poked, the depth view (5 rows, gray, within 2
                      levels of the NumPy form), k-sigma and fov, zoom,
                      a resize to 720p, POST /load of trained_500k.ply
                      and trained_2m.gsz (200 with the count) and of a
                      bad name (400), /stats with the JAX module's
                      keys, a 500k-splat 4D scene whose two times give
                      two frames; apps/cull_sort_test (gr-render) on
                      trained_500k.ply at its defaults for 120 frames
                      (two EMA lines, final:, the screenshot) beside a
                      synchronized median of 10 Canvas frames;
                      cull_sort_test --serve and window_test as served
                      processes (one /frame each, its size checked);
                      apps/fit --serve 0 --serve-every 10 for 20 steps
                      on fit-app's dataset with the monitor polled
                      (step 20 of 20, a PNG of the dataset's size);
                      the compositor's launches equal to the frames,
                      the train kernels' calls counted;
20. train-bench-shape
                    — step ms at tools/train_bench.py's shape (500k
                      random splats, 800×800, Adam 1e-2, MSE).
21. gemm            — the GEMM harness: the port's apps/matrix_test at
                      N = 8192 on random and on ones inputs, both served
                      by the wgmma + TMA kernel straight from the inputs
                      (``sm90``), and at the odd N = 1001, served by the
                      ``packed`` route (a pack kernel, then the same
                      product kernel on the padded copies; exit 0: the
                      kernel within 1e-2 of torch.mm, out[0, 0] == N on
                      ones); the kernel within GEMM_MAX_REL of its plain
                      version at 8192³, every entry N on ones, and on the
                      edge shapes (both routes, both tile widths) and a
                      16-byte-misaligned input (``packed``), each case
                      with the route that served it and, on a mismatch,
                      the first differing (row, col); each route's ms
                      beside its plain version's, torch.mm's and its
                      bound (at 1001³ in turns with torch.mm, and each
                      kernel's device ms by torch.profiler), TFLOP/s,
                      launches per route;
22. block-sort      — block_sort_runs at C = 5,586,944 (bench_3m's
                      instances rounded up to run 2048): one call, one
                      kernel launch; the kernels bit-equal to their plain
                      version on all 9 rows for random u32 keys (half ≥
                      2³¹) and tie-heavy keys at runs 256 to 65536 (C
                      rounded up to a multiple of the run); kernel, plain
                      and library (torch.sort of the key view + one
                      gather) ms beside the bound, kernel launches a call;
23. sort-harness    — the port's apps/onesweep and apps/radix_test with
                      their defaults on the card: exit 0, every JSONL
                      record (build/radix_bench_port.jsonl) true on its
                      checks.

Then one JSON line of per-kernel numbers (nine kernels: the GEMM's two
routes, and the segment sum and the densify draw, which replace no TPU
kernel),
the card line
again, and as the last line ``{"ok": true, "device": {...}}``. Any failed
check raises and the script exits non-zero without the ok line. Logs go
to stderr.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings

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
#: A pixel past its stop (T < 1e-3) needs nothing more, unless the frame
#: has an alpha row: then each lane whose AABB holds it still updates its
#: T (box 2, offsets 2, quadratic 7, exponent argument 2, fast_exp 18,
#: clamp 1, alpha test 1, T update 2), and every other lane costs it the
#: box test.
OPS_T_ONLY = OPS_BOX_TEST + 31 + 2
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
#: The largest table the lookup kernel stages (csrc/lookup.cu kMaxEntries:
#: 227 KB of shared memory as bf16).
LOOKUP_MAX_ENTRIES = 232448 // 2

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
#: The fit main path (fit_scene on those views): steps, the densify and
#: checkpoint cadences (episodes at 20 and 40 of 60 with densify_stop 0.7),
#: the step resumed from, and the synchronized steps timed with and
#: without densify. Every sum of the step has a fixed order on the card,
#: so the fit repeats itself and its resume bit for bit, as the JAX
#: package's tests/test_train.py holds its own.
FIT_STEPS = 60
FIT_DENSIFY_EVERY = 20
FIT_CHECKPOINT_EVERY = 30
FIT_TIMED_STEPS = 10
#: The densify draw (ops/cuda/prng.py): normals within this many f32 ulp
#: of the plain version's (the CPU's or the card's log1p under XLA's
#: erf_inv polynomial).
PRNG_MAX_ULP = 4
#: Least float operations of one normal: the uniform's subtract,
#: multiply, add and max (4); erf_inv's square, log1p, compare, offset,
#: 8 fused multiply-adds (16) and the products by u and √2 (22).
#: threefry2x32's some 73 integer operations a value are not charged.
PRNG_FLOPS_PER_VALUE = 4 + 22
#: Launches in one back-to-back timing of the draw kernel.
PRNG_BURST = 100
#: One episode on the card against the CPU: positions and raw_scales
#: within this of 1 + |value| (a few ulp of the normals and of each
#: device's quaternion norm and log).
DRAW_EPISODE_REL = 1e-5
#: The fit-app dataset: views on the training orbit, 640×480 .npy targets.
FIT_APP_VIEWS = 8
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
#: (M, K, N, block, route): an edge shape no 128-tile divides, with
#: 8-blocks, which the sm90 route takes through TMA's zero fill (128×64
#: tiles); an odd shape with 1-blocks, smaller than one tile, whose K and
#: N TMA cannot describe (the packed route); an odd shape large enough
#: for 128×256 tiles through the packed route.
GEMM_EDGE_SHAPES = ((264, 136, 328, 8, "sm90"), (37, 13, 29, 1, "packed"),
                    (2049, 1001, 4097, 1, "packed"))
#: (M, K, N, block) of the misaligned case: A starts 2 bytes into its
#: storage, so TMA cannot take it and the packed route serves it.
GEMM_MISALIGNED = (264, 136, 328, 8)
#: matrix_test's odd run (N and its 7-blocks not multiples of 8): the
#: harness path through the packed route.
GEMM_ODD_N, GEMM_ODD_BLOCK = 1001, 7
#: The block sort at the render path's instance count: bench_3m's
#: 5,585,012 instances rounded up to the default run of 2048.
BLOCK_SORT_C = 5_586_944
#: Runs held against the plain version: the smallest, the default, twice
#: the default, the largest one block sorts alone, and three that take
#: global passes. A run that does not divide BLOCK_SORT_C takes C rounded
#: up to its multiple.
BLOCK_SORT_RUNS = (256, 2048, 4096, 8192, 16384, 32768, 65536)
# The capture phases: scene formats on the repo's largest scene, then a
# COLMAP and a NeRF-synthetic capture rendered from the repo's surface
# scene, fit, scored and edited through the apps.
SCENE_2M = os.path.join(REPO, "data", "trained_2m.gsz")
SCENE_SURFACE = os.path.join(REPO, "data", "trained_surface_100k.gsz")
SCENE_2M_SPLATS = 1_999_994
FORMATS_H, FORMATS_W = 1080, 1920
FORMATS_FRAMES = 10
FORMATS_Q16_MIN_PSNR = 55.0  # tests/test_compact.py:95
FORMATS_SPLAT_MIN_PSNR = 35.0  # at SH degree 0, tests/test_compact.py:243-263
COLMAP_VIEWS = 12
COLMAP_H, COLMAP_W = 720, 1280
COLMAP_POINTS = 20_000
COLMAP_FIT_N = 100_000
COLMAP_FIT_STEPS = 60
POINTS_READ_CAPTURE = 1_000_000  # a capture-scale points3D.bin, read and timed
#: The C++ PLY reader's f32 sigmoid and exp against NumPy's, in ulp
#: (measured on both repo PLYs: 4 in opacity, 2 in scales).
NATIVE_MAX_ULP = 4
NATIVE_H, NATIVE_W = 1080, 1920  # native-io's trained_500k frame
BLENDER_SIZE = 800  # the published NeRF-synthetic frame
BLENDER_TRAIN, BLENDER_TEST = 12, 4
BLENDER_FIT_STEPS = 40
# The viewer phase: a 1080p Canvas on the repo's largest scene at
# formats-2m's first pose, its browser viewer over localhost HTTP, and
# the apps that serve it.
SCENE_500K = os.path.join(REPO, "data", "trained_500k.ply")
VIEWER_H, VIEWER_W = 1080, 1920
VIEWER_RESIZE = (720, 1280)
VIEWER_POSE = (3.9, 1.7, 3.9)
VIEWER_FRAMES = 10
VIEWER_STREAM_FRAMES = 30
VIEWER_4D_SPLATS = 500_000
VIEWER_HTTP_TIMEOUT = 120
VIEWER_APP_START_S = 300
#: The depth view against its NumPy form: the min-max scaling amplifies
#: float differences (tests/test_torch_viewer.py holds the same 2).
DEPTH_VIEW_LEVELS = 2
#: The JAX web viewer's /stats keys.
VIEWER_STATS_KEYS = ("frames", "ema_ms", "fps", "gaussians", "spacetime", "k_sigma",
                     "fov_y", "flip_y", "view_mode", "frame")
GR_RENDER_FRAMES = 120
VIEWER_FIT_STEPS = 20
VIEWER_FIT_SERVE_EVERY = 10
#: Operations per compare-exchange pair and substage: one compare, and a
#: select for each of the 9 rows of both outputs.
OPS_COMPARE_EXCHANGE = 19
#: The multi-device phases: D ranks that share the one card over gloo
#: (NCCL needs a card per rank), so their numbers show correctness and
#: what the exchange costs, not scaling. D = 2 on equal strips (bench_3m's
#: 34 tile rows) and on balanced ones (trained_500k's 15), D = 4 on
#: balanced strips and rects; timed frames per case; the tolerances of
#: tests/test_multichip.py (2e-4 packed, 2e-5 for the f32 records on the
#: xla compositor) and of the train phases' gradients (1e-3 of the
#: largest).
MC_D_SMALL = 2
MC_D_BALANCED = 4
MC_EXCHANGES = ("gather32", "gather_q", "a2a_q")
MC_FRAMES = 5
MC_NCCL_FRAMES = 2
MC_ATOL_PACKED = 2e-4
MC_ATOL_F32 = 2e-5
MC_GRAD_REL = 1e-3
MC_TRAIN_STEPS = 10
MC_FIT_STEPS = 20
MC_FIT_CHECKPOINT = 10
MC_SPAWN_TIMEOUT = 600.0


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


def cuda_ms_turns(torch, fns, reps):
    """Median CUDA-event ms of each of ``fns`` (after one warm-up each),
    timed in turns, one call of each per round, so that a slow spell of
    the host falls on all of them alike."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for t, fn in zip(times, fns):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            t.append(e0.elapsed_time(e1))
    return [statistics.median(t) for t in times]


def compositor_pairs(torch, inst, cfg, out_alpha, depth_row=None):
    """The (in-image pixel, walked lane) pairs of this frame, counted by
    the plain compositor on the card over every tile: inside the lane's
    AABB before the pixel's stop (T before the lane ≥ 1e-3), outside it
    before the stop, inside after the stop, outside after the stop."""
    from gaussianrenderer_tpu_torch.ops.cuda.tile_render2 import (
        composite_tiles_packed_plain,
    )

    counts = torch.zeros(4, dtype=torch.int64, device=DEVICE)
    composite_tiles_packed_plain(
        inst.packed_feats, inst.tile_start, inst.tile_count, depth_row=depth_row,
        pair_counts=counts, **comp_kwargs(cfg, out_alpha),
    )
    keys = ("live_in_aabb", "live_outside_aabb", "stopped_in_aabb",
            "stopped_outside_aabb")
    return dict(zip(keys, (int(v) for v in counts.tolist())))


def compositor_bytes_s(inst, cfg, nc, depth):
    """Seconds at the HBM peak for the bytes the function must move:
    records, depth row and ranges in, framebuffer out."""
    n_lanes = inst.packed_feats.shape[1]
    n_bytes = (n_lanes * (RECORD_BYTES + (4 if depth else 0)) + 8 * cfg.num_tiles
               + 4 * nc * cfg.height * cfg.width)
    return n_bytes / PEAK_HBM_BYTES


def compositor_bound_ms(pairs, inst, cfg, nc, out_alpha, depth=False):
    """Least time for this frame's compositor work on an H100: the larger
    of the operations the function needs over the fp32 peak and the bytes
    it must move over the HBM peak.

    ``pairs`` is :func:`compositor_pairs`'s count. A live pair inside the
    lane's AABB costs ``OPS_IN_BOX`` (+ ``OPS_DEPTH`` with a depth row), a
    live pair outside it ``OPS_BOX_TEST``; a pixel past its stop costs
    nothing more, except with an alpha row (``out_alpha``), where it
    still updates T (``OPS_T_ONLY`` inside an AABB, the box test outside).
    Returns (ms, "operations" | "bytes")."""
    ops = (pairs["live_in_aabb"] * (OPS_IN_BOX + (OPS_DEPTH if depth else 0))
           + pairs["live_outside_aabb"] * OPS_BOX_TEST)
    if out_alpha:
        ops += (pairs["stopped_in_aabb"] * OPS_T_ONLY
                + pairs["stopped_outside_aabb"] * OPS_BOX_TEST)
    ops_s = ops / PEAK_FP32_FLOPS
    bytes_s = compositor_bytes_s(inst, cfg, nc, depth)
    if ops_s >= bytes_s:
        return ops_s * 1e3, "operations"
    return bytes_s * 1e3, "bytes"


def compositor_bounds(torch, inst, cfg):
    """The bound of an rgb frame without an alpha row and its pair counts."""
    pairs = compositor_pairs(torch, inst, cfg, False)
    bound_ms, bound_by = compositor_bound_ms(pairs, inst, cfg, 3, False)
    return {"bound_ms": bound_ms, "bound_by": bound_by, "pairs": pairs}


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

    # Tiles of more than 1024 pixels: 64×128 (8192 pixels) with and without
    # an alpha row, and 128×128 with the census (64 blocks) with and
    # without one (without, as the culled session calls it: groups of 32
    # rectangles with their state in the scratch, stopped groups skipped),
    # on a dense overdraw frame; then the 64×128 grid through render_frame.
    dense = gt.make_random_scene(30000, seed=0, extent=2.0, scale_range=(0.02, 0.08),
                                 device=DEVICE)
    cam_d = look_camera(gt, (0.0, 0.0, 2.5), 768 / 512)
    for name, grid, out_alpha, with_sat in (
        ("768x512 64x128 tiles", (12, 4), False, False),
        ("768x512 64x128 tiles alpha", (12, 4), True, False),
        ("768x512 128x128 tiles with_sat", (6, 4), False, True),
        ("768x512 128x128 tiles with_sat alpha", (6, 4), True, True),
    ):
        cfg = gt.RenderConfig(height=512, width=768, num_tile_x=grid[0],
                              num_tile_y=grid[1])
        check(cfg.packed_compatible, f"{name}: not packed_compatible")
        inst = packed_frame(gt, dense, cam_d, cfg, False)
        rows = ("r", "g", "b", "alpha")[:3 + out_alpha]
        walked = []
        outs = []
        for fn in (gt.composite_tiles_packed, composite_tiles_packed_plain):
            walked.append(torch.zeros(cfg.num_tiles, dtype=torch.int32, device=DEVICE))
            outs.append(fn(inst.packed_feats, inst.tile_start, inst.tile_count,
                           chunks_walked=walked[-1], with_sat=with_sat,
                           **comp_kwargs(cfg, out_alpha)))
        if with_sat:
            (k_out, k_sat), (p_out, p_sat) = outs
            check_sat(torch, name, k_sat, p_sat)
        else:
            k_out, p_out = outs
        worst = max(worst, compare(torch, name, k_out, p_out, rows))
        check_walked(torch, name, walked[0], walked[1])
    cfg = gt.RenderConfig(height=512, width=768, num_tile_x=12, num_tile_y=4)
    gt.composite_tiles_packed.launches = 0
    fb, _ = gt.render_frame(dense, cam_d.params(cfg.k_sigma, device=DEVICE), cfg)
    torch.cuda.synchronize()
    check(gt.composite_tiles_packed.launches == 1 and fb.shape == (3, 512, 768)
          and bool(torch.isfinite(fb).all()) and float(fb.mean()) > 0.0,
          "render_frame on 64x128 tiles did not render through the kernel")
    out({"case": "render_frame 768x512 on 64x128 tiles", "kernel_launches": 1,
         "image_mean": float(fb.mean())})

    # 32 tiles of the full 1080p frame, the 16 heaviest and 16 random,
    # without and with an alpha row (the dead-warp stop runs only without).
    scene3m, cam3m, cfg3m = big
    inst = packed_frame(gt, scene3m, cam3m, cfg3m, False)
    err, tiles, geo, in_img = compare_frame_tiles(torch, gt, inst, cfg3m, "1080p 3M")
    worst = max(worst, err)
    sel = torch.as_tensor(tiles, device=DEVICE)
    kw = comp_kwargs(cfg3m, False)
    k_full, k_sat = gt.composite_tiles_packed(
        inst.packed_feats, inst.tile_start, inst.tile_count, with_sat=True, **kw
    )
    p_tiles, p_sat = composite_tiles_packed_plain(
        inst.packed_feats, inst.tile_start, inst.tile_count, tiles=tiles,
        with_sat=True, **kw
    )
    worst = max(worst, compare(torch, "1080p 3M: 32 tiles with_sat",
                               tile_blocks(k_full, tiles, **geo), p_tiles * in_img,
                               ("r", "g", "b")))
    n_blk = k_sat.numel() // cfg3m.num_tiles
    check_sat(torch, "1080p 3M: 32 tiles with_sat",
              k_sat.view(cfg3m.num_tiles, n_blk)[sel].reshape(-1), p_sat)
    return worst, inst, tiles


def compare_frame_tiles(torch, gt, inst, cfg, label):
    """The compositor kernel against its plain version on 32 tiles of one
    frame's packed instances (the 16 with the most instances, 16 seeded
    random), without and with an alpha row (the dead-warp stop runs only
    without), chunks walked equal. Returns (worst max |kernel − plain|,
    tiles, tile geometry, in-image mask of the tiles' blocks)."""
    from gaussianrenderer_tpu_torch.ops.cuda.tile_render2 import (
        composite_tiles_packed_plain,
        tile_blocks,
    )

    heavy = torch.topk(inst.tile_count, 16).indices.tolist()
    gen = torch.Generator().manual_seed(0)
    rest = [t for t in torch.randperm(cfg.num_tiles, generator=gen).tolist()
            if t not in heavy][:16]
    tiles = heavy + rest
    sel = torch.as_tensor(tiles, device=DEVICE)
    geo = dict(tiles_x=cfg.tiles_x, tile_w=cfg.tile_w, tile_h=cfg.tile_h)
    # Plain blocks include pixels past the image edge; the kernel writes
    # only in-image pixels, which tile_blocks pads with zeros.
    in_img = tile_blocks(torch.ones((1, cfg.height, cfg.width), device=DEVICE), tiles, **geo)
    worst = 0.0
    for out_alpha in (False, True):
        name = f"{label}: 32 tiles" + (" alpha" if out_alpha else "")
        kw = comp_kwargs(cfg, out_alpha)
        rows = ("r", "g", "b", "alpha")[:3 + out_alpha]
        k_walked = torch.zeros(cfg.num_tiles, dtype=torch.int32, device=DEVICE)
        p_walked = torch.zeros_like(k_walked)
        k_full = gt.composite_tiles_packed(
            inst.packed_feats, inst.tile_start, inst.tile_count, chunks_walked=k_walked,
            **kw
        )
        p_tiles = composite_tiles_packed_plain(
            inst.packed_feats, inst.tile_start, inst.tile_count, tiles=tiles,
            chunks_walked=p_walked, **kw
        )
        worst = max(worst, compare(torch, name, tile_blocks(k_full, tiles, **geo),
                                   p_tiles * in_img, rows))
        check_walked(torch, name, k_walked[sel], p_walked[sel])
    return worst, tiles, geo, in_img


def check_walked(torch, name, k_walked, p_walked):
    """Chunks walked by the kernel and the plain version, equal on every tile."""
    diff = int((k_walked != p_walked).sum())
    out({"case": name, "tiles": k_walked.numel(), "chunks_walked_differing": diff,
         "chunks_walked_max": int(k_walked.max())})
    check(diff == 0, f"{name}: chunks_walked differs on {diff} tiles")


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


def profiled_ms(torch, fn, reps=20):
    """Device time of one ``fn()`` from torch.profiler: the CUDA kernels'
    summed time over ``reps`` calls, divided by ``reps``; with the
    kernels' names. "not measured" if the profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, names = 0.0, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            total += e.self_cuda_time_total if us is None else us
            names.append(e.key[:60])
    return (total / 1e3 / reps if total > 0 else "not measured"), names


def enqueue_us(torch, fn, reps=1000):
    """Host microseconds per ``fn()`` while the card keeps up: the time to
    enqueue ``reps`` calls back to back, over ``reps``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def phase_lookup(torch, gt, big, card):
    """The lookup kernel against its plain version, bit for bit, on the
    inputs bench_3m's culled frames give it, with out-of-range indices,
    on a 4K pyramid, on a table of kMaxEntries, with a tail and with
    misaligned index views; then its times at the 3M rect_cutoff shape."""
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
    tab_max = torch.rand((LOOKUP_MAX_ENTRIES,), generator=gen, device=DEVICE) * 1e4
    idx_max = torch.randint(-64, LOOKUP_MAX_ENTRIES + 64, (1_000_003,), generator=gen,
                            device=DEVICE, dtype=torch.int32)
    # Views that start 4 (int32) and 8 (int64) bytes past a 16-byte
    # boundary, and lengths that leave a tail after the last whole vector.
    rect_off = torch.cat([rect_i[:1], rect_i])[1:]
    pos_off = torch.cat([pos_i[:1], pos_i])[1:]
    check(rect_off.data_ptr() % 16 == 4 and pos_off.data_ptr() % 16 == 8,
          "lookup: the misaligned index views are aligned")
    cases = (
        ("1080p pyramid, 3M rect_cutoff indices", rect_t, rect_i, rect_kw),
        ("frame-2 candidate lanes (int64 tile ids)", pos_t, pos_i, pos_kw),
        ("1080p pyramid, out-of-range indices", rect_t, torch.cat([wild, near_edge]),
         rect_kw),
        ("4K pyramid", tab4k, idx4k, dict(r=128 * -(-m4k // 16384), q=128)),
        ("table of kMaxEntries, tail of 3", tab_max, idx_max,
         dict(r=128 * -(-LOOKUP_MAX_ENTRIES // 16384), q=128)),
        # A head of 3 int32 to the boundary, then 4 a vector: 2 left over.
        ("1080p pyramid, int32 view 4 bytes off, tail of 2", rect_t,
         rect_off[:(rect_off.numel() - 5) // 4 * 4 + 5], rect_kw),
        # A head of 1 int64, then 2 a vector: 1 left over.
        ("frame-2 lanes, int64 view 8 bytes off, tail of 1", pos_t,
         pos_off[:pos_off.numel() // 2 * 2], pos_kw),
        ("1080p pyramid, 7 indices 4 bytes off", rect_t, rect_off[:7], rect_kw),
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
        kernel = lambda: gt.table_lookup(table, idx, **kw)  # noqa: E731
        plain_ms = cuda_ms(torch, lambda: table_lookup_plain(table, idx, **kw), reps)
        tab_r = table.to(torch.bfloat16).to(torch.float32)
        idx_c = torch.clamp(idx.to(torch.int64), 0, table.numel() - 1)
        library = lambda: torch.take(tab_r, idx_c)  # noqa: E731
        # Both take some 0.02 ms, as much host time as card time: timed in
        # turns over many rounds, so the host's spread falls on both.
        ms, library_ms = cuda_ms_turns(torch, (kernel, library), 10 * reps)
        device_ms, device_kernels = profiled_ms(torch, kernel)
        library_device_ms, library_kernels = profiled_ms(torch, library)
        return {
            "n": idx.numel(), "index_bytes": idx.element_size(), "table_entries": table.numel(),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "device_ms": device_ms, "library_device_ms": library_device_ms,
            "device_kernels": device_kernels, "library_device_kernels": library_kernels,
            "host_enqueue_us": enqueue_us(torch, kernel),
            "library_host_enqueue_us": enqueue_us(torch, library),
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
    frame and kernel times, kernel launches on the timed run; the
    compositor's bound."""
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
    kernel_ms = cuda_ms(torch, lambda: comp(
        inst.packed_feats, inst.tile_start, inst.tile_count, **kw), frames)
    bounds = compositor_bounds(torch, inst, cfg)
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
        **bounds,
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
    bounds = compositor_bounds(torch, inst, cfg)
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
        "culled_frame_compositor_bound_ms": bounds["bound_ms"],
        "culled_frame_compositor_bound_by": bounds["bound_by"],
        "culled_frame_compositor_bounds": bounds,
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


def heavy_overdraw_inputs(gt, tiles=(0, 0)):
    """tests/test_train_kernel.py's heavy-overdraw case at 4× the splats
    and 256×256 (tiles of over 20 chunks, saturation, the 0.99 clamp), on
    auto 32×32 tiles or a ``tiles`` = (x, y) grid of them."""
    import torch

    scene = gt.make_random_scene(16000, seed=11, extent=0.8, scale_range=(0.2, 0.6),
                                 device=DEVICE)
    scene = scene._replace(opacity=torch.clamp(scene.opacity * 4.0, 0.0, 1.0))
    cfg = gt.RenderConfig(height=256, width=256, num_tile_x=tiles[0], num_tile_y=tiles[1],
                          compositor="diff")
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


def same_bits(torch, a, b):
    """True where two tensors hold the same bits: equal shape and type,
    NaN where NaN, and every other entry bit for bit (so 0.0 is not
    -0.0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    a, b = torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)
    return bool(torch.equal(a.contiguous().view(ints), b.contiguous().view(ints)))


def params_bit_equal(torch, a, b):
    """Every leaf of two SceneParams bit-equal (None where None)."""
    return all((x is None and y is None) or (x is not None and y is not None
                                             and same_bits(torch, x, y))
               for x, y in zip(a, b))


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
    lanes past the last tile exactly 0; two launches of the backward bit
    for bit equal."""
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
    repeat_equal = same_bits(torch, d_k, tt.train_backward(*args, gout, stats_k, chk_k, **kw))
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
           "bwd_two_launches_bit_equal": repeat_equal,
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
    check(repeat_equal, f"{name}: two launches of the backward kernel differ")
    return (max(fwd_err, chk_err), (bwd_abs, max(max(rel.values()), max(chain_rel.values()))),
            (stats_k, chk_k, off, n_chk, gout, stats_p, chk_p))


def pass_ms(torch, fn, reps=5):
    """Device ms of one ``fn()`` by kernel (torch.profiler, summed over
    ``reps`` calls, over ``reps``), by the kernel's name without its
    namespaces and arguments; empty if the profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.split("<")[0].split("::")[-1]
            by_name[name] = by_name.get(name, 0.0) + (
                e.self_cuda_time_total if us is None else us) / 1e3 / reps
    return by_name


def segment_sum_bound_ms(m, d, n):
    """Least time of one segment sum of ``m`` rows of ``d`` f32 into ``n``
    segments on an H100, as the training gather's transpose calls it:
    bytes (the rows and their int32 order read once, the n + 1 int32
    offsets read once, the (n, D) sums written once) over the HBM peak;
    its one add per element read is far below the fp32 peak."""
    n_bytes = m * d * 4 + m * 4 + (n + 1) * 4 + n * d * 4
    return n_bytes / PEAK_HBM_BYTES * 1e3


def phase_segment_sum(torch, rows, ids, n, slot, start):
    """The segment sum (the transpose of the instance-row gather) on the
    rows the train-500k first step's backward gives it, by both routes:
    the backward's own call on the assignment's ``segment_slot`` and
    ``segment_start`` (no sort; the emission's segments, checked equal to
    the stable argsort of the ids and its searched offsets) and the
    argsort route from the ids. Both against each other, the plain
    version on the card and the CPU's index_add_ of the same rows (bit
    for bit: all add each splat's rows in their index order), two
    launches bit-equal; both calls' ms in turns with one index_add_'s,
    the kernel's device ms (torch.profiler, and a burst of 20 calls back
    to back), the plain version's ms and the bound."""
    from gaussianrenderer_tpu_torch.ops.cuda import segment_sum as seg

    order, offsets = seg.segments(ids, n)
    segments_equal = bool(torch.equal(slot.to(torch.int64), order)
                          and torch.equal(start.to(torch.int64), offsets))
    del order, offsets
    before = seg.segment_sum.launches
    got = seg.segment_sum_ordered(rows, slot, start)
    again = seg.segment_sum_ordered(rows, slot, start)
    launched = seg.segment_sum.launches - before
    argsort = seg.segment_sum(rows, ids, n)
    plain = seg.segment_sum_ordered_plain(rows, slot, start)
    cpu = torch.zeros((n, rows.shape[1])).index_add_(0, ids.cpu(), rows.cpu())
    ordered_call = lambda: seg.segment_sum_ordered(rows, slot, start)  # noqa: E731
    argsort_call = lambda: seg.segment_sum(rows, ids, n)  # noqa: E731
    library = lambda: rows.new_zeros((n, rows.shape[1])).index_add_(0, ids, rows)  # noqa: E731
    ms, argsort_ms, library_ms = cuda_ms_turns(torch, [ordered_call, argsort_call, library], 10)
    max_err = float((got - plain).abs().max())
    res = {
        "rows": rows.shape[0], "segments": n, "columns": rows.shape[1],
        "longest_segment": int(torch.bincount(ids, minlength=n).max()),
        "emission_segments_equal_argsort": segments_equal,
        "launches_of_two_calls": launched,
        "two_launches_bit_equal": same_bits(torch, got, again),
        "bit_equal_to_argsort_route": same_bits(torch, got, argsort),
        "bit_equal_to_plain": same_bits(torch, got, plain),
        "bit_equal_to_cpu_index_add": same_bits(torch, got.cpu(), cpu),
        "argsort_route_bit_equal_to_cpu_index_add": same_bits(torch, argsort.cpu(), cpu),
        "index_add_on_card_max_abs_vs_kernel": float((library() - got).abs().max()),
        "max_abs_err": max_err,
        "ms": ms, "argsort_route_ms": argsort_ms, "library_ms": library_ms,
        "no_slower_than_index_add": ms <= library_ms,
        "timed": "CUDA events, median of 10, the three calls in turns",
        "argsort_route_device_ms": pass_ms(torch, argsort_call),
        # The profiler has seen no kernel in this call late in a long run
        # (a fresh process sees it); the burst times the kernel either way.
        "device_ms": pass_ms(torch, ordered_call) or "not measured",
        "burst_ms": cuda_ms(torch, lambda: [ordered_call() for _ in range(20)], 3) / 20,
        "plain_ms": cuda_ms(torch, lambda: seg.segment_sum_ordered_plain(rows, slot, start), 1),
        "bound_ms": segment_sum_bound_ms(rows.shape[0], rows.shape[1], n),
        "bound_by": "bytes",
        "library_call": "torch.zeros((n, 16)).index_add_(0, ids, rows) (float atomics)",
    }
    out({"segment_sum": res})
    check(segments_equal, "segment sum: the emission's segments differ from the argsort's")
    check(launched == 2, f"segment sum: {launched} launches in two calls")
    check(res["two_launches_bit_equal"], "segment sum: two launches differ")
    check(res["bit_equal_to_argsort_route"], "segment sum: the two routes differ")
    check(res["bit_equal_to_plain"], f"segment sum: kernel vs plain max {max_err:.3g}")
    check(res["bit_equal_to_cpu_index_add"], "segment sum: kernel vs the CPU's index_add_")
    check(res["argsort_route_bit_equal_to_cpu_index_add"],
          "segment sum: the argsort route vs the CPU's index_add_")
    return res


def launches_per_call(torch, fn, counter):
    """Kernel launches one ``fn()`` makes, read off ``counter.kernel_launches``."""
    before = counter.kernel_launches
    fn()
    torch.cuda.synchronize()
    return counter.kernel_launches - before


def phase_train_kernel_vs_plain(torch, gt, frame):
    """The train kernels against their plain versions: the train-500k
    frame's first step (pose 0, perturbed params) and the heavy-overdraw
    case on 32×32 and on 64×128 tiles (8192 pixels); then, on the former,
    the kernels' and plain versions' times, each pass's device time and
    the kernel launches of one call."""
    from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt

    sf, asg, cfg, n_splats = frame
    fwd_err, bwd_err, (stats, chk, off, n_chk, gout, stats_p, chk_p) = compare_train(
        torch, f"trained_500k {cfg.width}x{cfg.height}, first step", sf, asg, cfg)
    # The segment sum on the rows this backward gives the gather's transpose.
    ids = asg.gaussian_id.to(torch.int64)
    d_feats = tt.train_backward(sf, asg.tile_start, asg.tile_count, off, gout, stats, chk,
                                **train_kw(cfg))
    seg_res = phase_segment_sum(torch, d_feats[: ids.shape[0]].contiguous(), ids, n_splats,
                                asg.segment_slot, asg.segment_start)
    del d_feats
    errs = [(fwd_err, bwd_err)]
    for tiles in ((0, 0), (4, 2)):
        heavy = heavy_overdraw_inputs(gt, tiles)
        hc = heavy[2]
        errs.append(compare_train(
            torch, f"heavy overdraw {hc.width}x{hc.height}, {hc.tile_w}x{hc.tile_h} tiles",
            *heavy)[:2])
        del heavy
    kw = train_kw(cfg)
    args = (sf, asg.tile_start, asg.tile_count, off)
    fwd = lambda: tt.train_forward(*args, n_chk, **kw)  # noqa: E731
    bwd = lambda: tt.train_backward(*args, gout, stats, chk, **kw)  # noqa: E731
    per_call = {"fwd": launches_per_call(torch, fwd, tt.train_forward),
                "bwd": launches_per_call(torch, bwd, tt.train_backward)}
    passes = {"fwd": pass_ms(torch, fwd), "bwd": pass_ms(torch, bwd)}
    times = {
        "fwd_ms": cuda_ms(torch, fwd, 10),
        "bwd_ms": cuda_ms(torch, bwd, 10),
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
        "kernel_launches_per_call": per_call, "pass_device_ms": passes,
        "fwd_max_abs_err": max(f for f, _ in errs),
        "bwd_max_abs_err": max(b[0] for _, b in errs),
        "bwd_max_rel_err": max(b[1] for _, b in errs),
    }}
    out(res)
    return {**res["train_kernel_times"], "segment_sum": seg_res}


def grads_finite(torch, gt, params, camp, target, cfg):
    leaves = gt.SceneParams(*(None if p is None else p.detach().requires_grad_(True)
                              for p in params))
    loss = gt.l1_dssim_loss(leaves, camp, target, cfg)
    grads = torch.autograd.grad(loss, [p for p in leaves if p is not None])
    return all(bool(torch.isfinite(g).all()) for g in grads)


def step_grads(torch, gt, params, camp, target, cfg):
    """One training step's gradients as the densifying step takes them:
    ({leaf or "ndc": gradient}, loss), the NDC probe's gradient the
    view-space one that densification keys on."""
    leaves = gt.SceneParams(*(None if p is None else p.detach().requires_grad_(True)
                              for p in params))
    probe = torch.zeros((2, params.positions.shape[0]), dtype=torch.float32,
                        device=params.positions.device, requires_grad=True)
    loss = gt.l1_dssim_loss(leaves, camp, target, cfg, ndc_probe=probe)
    names = [f for f, p in zip(gt.SceneParams._fields, leaves) if p is not None]
    grads = torch.autograd.grad(loss, [p for p in leaves if p is not None] + [probe])
    return dict(zip(names + ["ndc"], grads)), loss.detach()


def phase_train_repro(torch, gt, params0, camp, target, cfg, opt):
    """train-500k from one state, twice: every parameter's gradient, the
    NDC gradient and the loss bit-equal, and two make_train_step steps'
    params, Adam moments and losses bit-equal."""
    g1, l1 = step_grads(torch, gt, params0, camp, target, cfg)
    g2, l2 = step_grads(torch, gt, params0, camp, target, cfg)
    res = {"grads": {k: same_bits(torch, g1[k], g2[k]) for k in g1}}
    res["grads"]["loss"] = same_bits(torch, l1, l2)
    del g1, g2
    step, _ = gt.make_train_step(cfg, optimizer=opt, loss_fn=gt.l1_dssim_loss)
    a = step(params0, opt.init(params0), camp, target)
    b = step(params0, opt.init(params0), camp, target)
    res["step"] = {"params": params_bit_equal(torch, a[0], b[0]),
                   "mu": params_bit_equal(torch, a[1].mu, b[1].mu),
                   "nu": params_bit_equal(torch, a[1].nu, b[1].nu),
                   "loss": same_bits(torch, a[2], b[2])}
    out({"train_repro": res})
    for part, equal in res.items():
        differ = [k for k, v in equal.items() if not v]
        check(not differ, f"train-500k: two runs from one state differ in {part} {differ}")
    return res


def phase_train(torch, gt, scene, card):
    """The training main path at full width: make_train_step with the
    3DGS optimizer and l1_dssim_loss on data/trained_500k.ply at 640×480,
    TRAIN_STEPS steps cycling TRAIN_POSES views whose targets are the
    fitted params' own renders, from a seeded perturbation. Counts of
    both train kernels and the segment sum are set to 0 just before the
    steps and read just after. Then the step twice from one state
    (phase_train_repro) and CUDA-event stage times of one step."""
    from gaussianrenderer_tpu_torch.ops.compositing import gather_sorted_features_seg
    from gaussianrenderer_tpu_torch.ops.cuda import segment_sum as seg
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
    tt.train_forward.kernel_launches = tt.train_backward.kernel_launches = 0
    seg.segment_sum.launches = 0
    for s in range(TRAIN_STEPS):
        i = s % TRAIN_POSES
        (params, state, loss), ms = host_ms(
            torch, lambda: step(params, state, cams[i], targets[i]))
        losses.append(float(loss))
        step_ms.append(ms)
    launches = {"tile_train_fwd": tt.train_forward.launches,
                "tile_train_bwd": tt.train_backward.launches}
    seg_launches = seg.segment_sum.launches
    kernel_launches = {"tile_train_fwd": tt.train_forward.kernel_launches,
                       "tile_train_bwd": tt.train_backward.kernel_launches}

    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(all(math.isfinite(v) for v in losses), f"train-500k: non-finite loss {losses}")
    check(last < first, f"train-500k: loss did not fall ({first:.5g} → {last:.5g})")
    check(launches == {"tile_train_fwd": TRAIN_STEPS, "tile_train_bwd": TRAIN_STEPS},
          f"train-500k: kernel calls {launches} in {TRAIN_STEPS} steps")
    check(all(kernel_launches[k] >= TRAIN_STEPS for k in launches),
          f"train-500k: kernel launches {kernel_launches} in {TRAIN_STEPS} steps")
    check(seg_launches == TRAIN_STEPS,
          f"train-500k: {seg_launches} segment-sum launches in {TRAIN_STEPS} steps")
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
    repro = phase_train_repro(torch, gt, params0, cams[0], targets[0], cfg, opt)

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
        "segment_sum_launches": seg_launches,
        "two_runs_bit_equal": all(all(v.values()) for v in repro.values()),
        "kernels_launched_by_the_calls": kernel_launches,
        "psnr_db_before": psnr_before, "psnr_db_after": psnr_after,
        "card": card,
    }
    out(res)
    return res


def fit_dir(name):
    """An empty scratch directory under the checkout's build/ (git-ignored)."""
    path = os.path.join(REPO, "build", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def tree_to(torch, x, dev):
    """A copy of nested tuples and dicts of tensors and Nones, every
    tensor moved to ``dev`` (``None``: cloned on its own device)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.clone() if dev is None else x.to(dev)
    if isinstance(x, dict):
        return {k: tree_to(torch, v, dev) for k, v in x.items()}
    items = [tree_to(torch, v, dev) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)


def episode_prune_scale(cams):
    """``fit_scene``'s size prune for these views: 0.1 of the cameras'
    spread (the farthest camera from their mean)."""
    import numpy as np

    cam_pos = np.stack([c.position.cpu().numpy() for c in cams])
    return 0.1 * float(np.linalg.norm(cam_pos - cam_pos.mean(axis=0), axis=1).max())


def phase_fit(torch, gt, scene, card):
    """The fit main path at full width: fit_scene on data/trained_500k.ply
    at 640×480 over the train-500k views (targets the file's own renders)
    from the seeded perturbation, l1_dssim_loss, the 3DGS Adam over
    FIT_STEPS, densify episodes every FIT_DENSIFY_EVERY steps, checkpoints
    every FIT_CHECKPOINT_EVERY; then evaluate on the views, the same fit
    again and a resume from the first checkpoint, both bit-equal to the
    first run (losses, episodes, final params). Counts of both train
    kernels and the segment sum are set to 0 just before the fit and read
    just after, and again after evaluate. Then the densifying step
    against the plain step in turns, and one densify_step episode (with
    no host wait: sync debug mode)."""
    from gaussianrenderer_tpu_torch import train as ptrain
    from gaussianrenderer_tpu_torch.ops.cuda import prng
    from gaussianrenderer_tpu_torch.ops.cuda import segment_sum as seg
    from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt

    cfg = train_500k_config(gt)
    cams = train_poses(gt, cfg)
    truth = gt.SceneParams.from_scene(scene)
    with torch.no_grad():
        views = [(c, gt.render_for_training(truth, c, cfg)) for c in cams]
    start = perturbed(torch, gt, truth)
    n = start.positions.shape[0]
    psnr_start = gt.evaluate(start, views, cfg)["psnr"]
    ck = fit_dir("chip_smoke_fit")
    kw = dict(steps=FIT_STEPS, loss_fn=gt.l1_dssim_loss, densify_every=FIT_DENSIFY_EVERY,
              densify_stop=0.7)

    def optimizer():
        return gt.make_3dgs_optimizer(position_lr_max_steps=FIT_STEPS)

    at_checkpoint = {}

    def keep(step, params, loss):
        at_checkpoint.setdefault(step, params)

    tt.train_forward.launches = tt.train_backward.launches = seg.segment_sum.launches = 0
    prng.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, hist = gt.fit_scene(views, cfg, start, optimizer=optimizer(), checkpoint_dir=ck,
                                checkpoint_every=FIT_CHECKPOINT_EVERY, snapshot_fn=keep,
                                snapshot_every=FIT_CHECKPOINT_EVERY, **kw)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    fit_launches = {"tile_train_fwd": tt.train_forward.launches,
                    "tile_train_bwd": tt.train_backward.launches,
                    "segment_sum": seg.segment_sum.launches,
                    "prng": prng.launches}
    t0 = time.perf_counter()
    report = gt.evaluate(fitted, views, cfg)
    evaluate_ms = (time.perf_counter() - t0) * 1e3
    eval_launches = {"tile_train_fwd": tt.train_forward.launches - fit_launches["tile_train_fwd"],
                     "tile_train_bwd": tt.train_backward.launches - fit_launches["tile_train_bwd"]}

    losses, episodes = hist["losses"], hist["densify"]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    checkpoints = sorted(os.listdir(ck))
    resume_dir = os.path.join(ck, f"step_{FIT_CHECKPOINT_EVERY:06d}")
    restored, _, _, _ = gt.load_checkpoint(resume_dir, start)
    restored_equal = params_bit_equal(torch, at_checkpoint[FIT_CHECKPOINT_EVERY], restored)
    # The repeat keeps its first episode's inputs for densify-draw (the
    # timed fit above runs without the copy).
    first_episode = {}
    real_densify_step = ptrain.densify_step

    def keep_first_episode(params, opt_state, dstate, **ekw):
        if not first_episode:
            first_episode.update(state=tree_to(torch, (params, opt_state, dstate), None),
                                 kwargs=ekw)
        return real_densify_step(params, opt_state, dstate, **ekw)

    ptrain.densify_step = keep_first_episode
    try:
        again, hist_a = gt.fit_scene(views, cfg, start, optimizer=optimizer(), **kw)
    finally:
        ptrain.densify_step = real_densify_step
    resumed, hist_r = gt.fit_scene(views, cfg, start, optimizer=optimizer(),
                                   resume_from=resume_dir, **kw)
    later = [e for e in episodes if e["step"] > FIT_CHECKPOINT_EVERY]
    repeat = {"losses": hist_a["losses"] == losses, "episodes": hist_a["densify"] == episodes,
              "params": params_bit_equal(torch, again, fitted)}
    resume = {"losses": hist_r["losses"] == losses[FIT_CHECKPOINT_EVERY:],
              "episodes": hist_r["densify"] == later,
              "params": params_bit_equal(torch, resumed, fitted)}
    del again, resumed, restored
    shutil.rmtree(ck)

    # The densifying step beside the plain one, in turns, from the start.
    opt = optimizer()
    dstep = ptrain._make_step_fn(cfg, opt, gt.l1_dssim_loss, timed=False, densify=True)
    pstep, _ = gt.make_train_step(cfg, optimizer=opt, loss_fn=gt.l1_dssim_loss)
    dp, dst, ds = start, opt.init(start), gt.DensifyState.zero(n, device=DEVICE)
    pp, pst = start, opt.init(start)
    first_needed = int(dstep(dp, dst, ds, *views[0])[4])
    pstep(pp, pst, *views[0])
    d_ms, p_ms = [], []
    for s in range(FIT_TIMED_STEPS):
        view = views[s % len(views)]
        (dp, dst, ds, _, _), ms = host_ms(torch, lambda: dstep(dp, dst, ds, *view))
        d_ms.append(ms)
        (pp, pst, _), ms = host_ms(torch, lambda: pstep(pp, pst, *view))
        p_ms.append(ms)
    prune = episode_prune_scale(cams)

    def episode():
        return gt.densify_step(dp, dst, ds, seed=1, prune_scale=prune)

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, _, _, info = episode()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    episode_ms = cuda_ms(torch, episode, 5)
    res = {
        "fit": "trained_500k",
        "gaussians": n,
        "num_instances_first_step": first_needed,
        "resolution": f"{cfg.width}x{cfg.height}",
        "views": len(views), "steps": FIT_STEPS,
        "fit_ms_per_step": fit_ms / FIT_STEPS,
        "fit_ms_per_step_counts": "wall clock of the whole fit_scene call, one "
                                  "synchronize at its end: 2 episodes, 2 checkpoints",
        "loss_first5_mean": first, "loss_last5_mean": last, "losses": losses,
        "episodes": episodes,
        "train_kernel_calls_fit": fit_launches,
        "train_kernel_calls_evaluate": eval_launches,
        "psnr_db_start": psnr_start, "psnr_db_fitted": report["psnr"],
        "ssim_fitted": report["ssim"],
        "evaluate_ms_per_view": evaluate_ms / len(views),
        "repeat_bit_equal": repeat,
        "resumed_from": FIT_CHECKPOINT_EVERY, "resumed_episodes": hist_r["densify"],
        "resumed_final_loss": hist_r["losses"][-1], "final_loss": losses[-1],
        "resumed_losses": hist_r["losses"], "resume_bit_equal": resume,
        "checkpoint_restores_bit_equal": restored_equal,
        "densify_step_ms_median": statistics.median(d_ms), "densify_step_ms_all": d_ms,
        "plain_step_ms_median": statistics.median(p_ms), "plain_step_ms_all": p_ms,
        "episode_ms_median_of_5": episode_ms,
        "episode_info": {k: int(v) for k, v in info.items()},
        "episode_host_waits": len(syncs),
        "card": card,
    }
    out(res)
    check(len(losses) == FIT_STEPS and all(math.isfinite(v) for v in losses),
          f"fit-500k: losses {losses}")
    check(last < first, f"fit-500k: loss did not fall ({first:.5g} → {last:.5g})")
    check([e["step"] for e in episodes] == [FIT_DENSIFY_EVERY, 2 * FIT_DENSIFY_EVERY],
          f"fit-500k: episodes {episodes}")
    check(all(0 <= e["recycled"] <= e["dead"] and e["recycled"] <= 4 * e["eligible"]
              for e in episodes), f"fit-500k: episode bookkeeping {episodes}")
    check(all(bool(torch.isfinite(p)[torch.isfinite(p0)].all())
              for p, p0 in zip(fitted, start) if p is not None),
          "fit-500k: a finite parameter became non-finite")
    check(fit_launches == {"tile_train_fwd": FIT_STEPS, "tile_train_bwd": FIT_STEPS,
                           "segment_sum": FIT_STEPS, "prng": len(episodes)},
          f"fit-500k: kernel calls {fit_launches} in {FIT_STEPS} steps, "
          f"{len(episodes)} episodes")
    check(first_episode.get("kwargs", {}).get("seed") == FIT_DENSIFY_EVERY,
          f"fit-500k: first episode's inputs {first_episode.get('kwargs')}")
    check(eval_launches == {"tile_train_fwd": len(views), "tile_train_bwd": 0},
          f"fit-500k: evaluate's train kernel calls {eval_launches}")
    check(report["psnr"] > psnr_start,
          f"fit-500k: PSNR {report['psnr']:.3f} not above the start's {psnr_start:.3f}")
    check(checkpoints == ["step_000030", "step_000060"], f"fit-500k: checkpoints {checkpoints}")
    check(restored_equal, "fit-500k: the step-30 checkpoint does not restore the fit's params")
    check(len(hist_r["losses"]) == FIT_STEPS - FIT_CHECKPOINT_EVERY,
          f"fit-500k: {len(hist_r['losses'])} resumed steps")
    check(all(repeat.values()),
          f"fit-500k: a second run of the fit differs from the first: {repeat} "
          f"(losses {hist_a['losses']}, episodes {hist_a['densify']})")
    check(all(resume.values()),
          f"fit-500k: the resume from step {FIT_CHECKPOINT_EVERY} differs from the fit: "
          f"{resume} (losses {hist_r['losses']}, episodes {hist_r['densify']})")
    check(not syncs, f"fit-500k: densify_step waits for the device: {syncs}")
    return res, first_episode


def prng_bound_ms(values, out_bytes):
    """(ms, "bytes" or "operations"): the least time of one draw of
    ``values`` on an H100, the larger of its output written once over the
    HBM peak (it reads nothing) and its float operations over the fp32
    peak (PRNG_FLOPS_PER_VALUE a value; the data sheet gives no rate for
    threefry's integer operations, so they are not charged)."""
    bytes_s = values * out_bytes / PEAK_HBM_BYTES
    ops_s = values * PRNG_FLOPS_PER_VALUE / PEAK_FP32_FLOPS
    return max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations"


def back_to_back_ms(torch, prng, seed, out):
    """CUDA-event ms a launch of PRNG_BURST normal draws into ``out``
    enqueued back to back through the C entry point (no allocation, no
    wrapper), so the card, not the host, sets the pace: the kernel's
    time with the gaps between launches."""
    from gaussianrenderer_tpu_torch import _build

    lib = _build.load("prng")
    stream = torch.cuda.current_stream(out.device).cuda_stream

    def burst():
        for _ in range(PRNG_BURST):
            check(lib.gr_prng(seed & 0xFFFFFFFF, out.numel(), 2, out.data_ptr(), stream) == 0,
                  "densify-draw: a back-to-back launch failed")

    return cuda_ms(torch, burst, 3) / PRNG_BURST


def rel_gap(torch, a, b):
    """max |a - b| / (1 + |b|) over the entries finite in both tensors;
    inf unless both hold NaN at the same places (data/trained_500k.ply
    has three splats with NaN parameters)."""
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return math.inf
    ok = torch.isfinite(a) & torch.isfinite(b)
    return float(((a - b).abs() / (1.0 + b.abs()))[ok].max())


def phase_densify_draw(torch, gt, n, first_episode, card):
    """The densify draw (``ops/cuda/prng.py``): the kernel at train-500k's
    (n, 3) against its plain version on the card and on the CPU (bits
    and uniforms bit for bit, normals within PRNG_MAX_ULP, the values
    that differ counted), two launches bit-equal, the bf16 draw of the
    GEMM harness against its plain version; the kernel's ms (the
    wrapper's call, the profiler's device time, a launch of a
    back-to-back burst) beside the plain version's, ``torch.randn``'s
    (the draw before this kernel: other samples) and the bound, and at
    the GEMM's 8192² in f32 and bf16. Then fit-500k's first
    episode from its inputs, on the card and on the CPU: counts, the
    recycled slots and their donors equal (read off a ``time_params``
    tag of each row's index, which the episode copies from the donor),
    positions and ``raw_scales`` (a split adds each device's log(1/1.6))
    within DRAW_EPISODE_REL of 1 + |value|, the rows not refilled
    bit-equal, every other leaf and moment bit-equal."""
    from gaussianrenderer_tpu_torch import train as ptrain
    from gaussianrenderer_tpu_torch.ops.cuda import prng

    seed, shape = FIT_DENSIFY_EVERY, (n, 3)
    dev = torch.device(DEVICE)
    bits, bits_plain = prng.random_bits(seed, shape, dev), prng.random_bits_plain(seed, shape, dev)
    u, u_plain = prng.uniform(seed, shape, dev), prng.uniform_plain(seed, shape, dev)
    eps, again = prng.normal(seed, shape, dev), prng.normal(seed, shape, dev)
    eps_plain = prng.normal_plain(seed, shape, dev)
    eps_cpu = prng.normal_plain(seed, shape)
    differ_plain, ulp_plain = ulp_diff(torch, eps, eps_plain)
    differ_cpu, ulp_cpu = ulp_diff(torch, eps.cpu(), eps_cpu)
    gn = (GEMM_N, GEMM_N)
    g16 = prng.normal(0, gn, dev, torch.bfloat16)
    g16_plain = prng.normal_plain(0, gn, dev, torch.bfloat16)
    g16_differ = int((g16.view(torch.int16) != g16_plain.view(torch.int16)).sum())
    g16_max_rel = float(((g16.float() - g16_plain.float()).abs()
                         / g16_plain.float().abs().clamp_min(1e-30)).max())
    del g16, g16_plain

    def randn():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    draw = {
        "shape": list(shape), "seed": seed,
        "bits_bit_equal_to_plain": bool(torch.equal(bits, bits_plain)),
        "bits_bit_equal_to_cpu": bool(torch.equal(bits.cpu(), prng.random_bits_plain(seed, shape))),
        "uniform_bit_equal_to_plain": same_bits(torch, u, u_plain),
        "uniform_bit_equal_to_cpu": same_bits(torch, u.cpu(), prng.uniform_plain(seed, shape)),
        "normal_ulp_max_vs_plain": ulp_plain, "normal_values_differing_vs_plain": differ_plain,
        "normal_ulp_max_vs_cpu": ulp_cpu, "normal_values_differing_vs_cpu": differ_cpu,
        "two_launches_bit_equal": same_bits(torch, eps, again),
        "max_abs_err": float((eps - eps_plain).abs().max()),
        "max_abs_err_vs_cpu": float((eps.cpu() - eps_cpu).abs().max()),
        "bf16_shape": list(gn), "bf16_values_differing_vs_plain": g16_differ,
        "bf16_max_rel_vs_plain": g16_max_rel,
        "ms": cuda_ms(torch, lambda: prng.normal(seed, shape, dev), 20),
        "device_ms": pass_ms(torch, lambda: prng.normal(seed, shape, dev), reps=10),
        "plain_ms": cuda_ms(torch, lambda: prng.normal_plain(seed, shape, dev), 3),
        "torch_randn_ms": cuda_ms(torch, randn, 20),
        "torch_randn_is": "the draw before this kernel (a seeded Philox Generator): "
                          "other samples, so no library_ms",
        "bound_flops_per_value": PRNG_FLOPS_PER_VALUE,
        "back_to_back_ms": back_to_back_ms(torch, prng, seed, eps),
        "bf16_ms": cuda_ms(torch, lambda: prng.normal(0, gn, dev, torch.bfloat16), 5),
        "bf16_bound_ms": prng_bound_ms(gn[0] * gn[1], 2)[0],
        "f32_at_bf16_shape_ms": cuda_ms(torch, lambda: prng.normal(0, gn, dev), 5),
        "f32_at_bf16_shape_bound_ms": prng_bound_ms(gn[0] * gn[1], 4)[0],
    }
    draw["bound_ms"], draw["bound_by"] = prng_bound_ms(n * 3, 4)
    draw["back_to_back_launches"] = PRNG_BURST
    del bits, bits_plain, u, u_plain, eps, again, eps_plain, eps_cpu

    # fit-500k's first episode on both devices, each row tagged with its
    # index in time_params (copied from the donor into a refilled slot).
    params, opt_state, dstate = first_episode["state"]
    tag = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    params = params._replace(time_params=tag)
    kw = first_episode["kwargs"]
    out_card = ptrain.densify_step(params, opt_state, dstate, **kw)
    torch.cuda.synchronize()
    cpu_in = tree_to(torch, (params, opt_state, dstate), "cpu")
    t0 = time.perf_counter()
    out_cpu = ptrain.densify_step(*cpu_in, **kw)
    cpu_s = time.perf_counter() - t0
    (pc, oc, _, ic), (pp, op, _, ip) = tree_to(torch, out_card, "cpu"), out_cpu
    info_card = {k: int(v) for k, v in ic.items()}
    info_cpu = {k: int(v) for k, v in ip.items()}
    tag_cpu = tag.cpu()
    refill_card = (pc.time_params != tag_cpu)[:, 0]
    refill_cpu = (pp.time_params != tag_cpu)[:, 0]
    donors_equal = bool(torch.equal(refill_card, refill_cpu)) and bool(torch.equal(
        pc.time_params[refill_card], pp.time_params[refill_cpu]))
    pos_rel = rel_gap(torch, pc.positions, pp.positions)
    leaves_equal = {f: same_bits(torch, getattr(pc, f), getattr(pp, f))
                    for f in ("sh", "raw_opacity", "quats")}
    moments_equal = all(same_bits(torch, a, b)
                        for m_c, m_p in ((oc.mu, op.mu), (oc.nu, op.nu))
                        for a, b in zip(m_c, m_p) if a is not None)
    scales_rel = rel_gap(torch, pc.raw_scales, pp.raw_scales)
    episode = {
        "from": f"fit-500k's first episode (step {kw['seed']}, the fit run again)",
        "kwargs": kw, "info_card": info_card, "info_cpu": info_cpu,
        "slots_refilled": int(refill_card.sum()),
        "refill_and_donors_equal": donors_equal,
        "positions_max_rel": pos_rel,
        "positions_untouched_bit_equal": same_bits(
            torch, pc.positions[~refill_card], pp.positions[~refill_cpu])
        if bool(torch.equal(refill_card, refill_cpu)) else False,
        "leaves_bit_equal": leaves_equal, "moments_bit_equal": moments_equal,
        "raw_scales_max_rel": scales_rel, "cpu_episode_s": cpu_s,
    }
    res = {"densify_draw": draw, "episode_card_vs_cpu": episode, "card": card}
    out(res)
    for key in ("bits_bit_equal_to_plain", "bits_bit_equal_to_cpu", "uniform_bit_equal_to_plain",
                "uniform_bit_equal_to_cpu", "two_launches_bit_equal"):
        check(draw[key], f"densify-draw: {key} is false")
    check(ulp_plain <= PRNG_MAX_ULP and ulp_cpu <= PRNG_MAX_ULP,
          f"densify-draw: normals {ulp_plain} / {ulp_cpu} ulp from the plain draw on the "
          "card / the CPU")
    check(g16_max_rel <= 2.0**-7, f"densify-draw: bf16 draw {g16_max_rel:.3g} from its plain version")
    check(info_card == info_cpu and info_card["recycled"] > 0,
          f"densify-draw: episode counts card {info_card}, CPU {info_cpu}")
    check(donors_equal, "densify-draw: the episode refills other slots or donors on the card")
    check(pos_rel <= DRAW_EPISODE_REL and episode["positions_untouched_bit_equal"],
          f"densify-draw: positions {pos_rel:.3g} apart (relative to 1 + |p|)")
    check(all(leaves_equal.values()) and moments_equal and scales_rel <= DRAW_EPISODE_REL,
          f"densify-draw: leaves {leaves_equal}, moments {moments_equal}, "
          f"raw_scales {scales_rel:.3g}")
    return res


def phase_fit_app(torch, gt, scene, card):
    """apps/fit on a poses.json dataset of FIT_APP_VIEWS trained_500k
    views at 640×480 (.npy targets), refining data/trained_500k.ply with
    densification, held-out views and checkpoints; again resumed from its
    first checkpoint; apps/train_test with its defaults."""
    import numpy as np

    from gaussianrenderer_tpu_torch.apps import fit, train_test

    cfg = train_500k_config(gt)
    truth = gt.SceneParams.from_scene(scene)
    root = fit_dir("chip_smoke_fit_app")
    data = fit_dir("chip_smoke_poses")  # kept for viewer-2m's fit --serve
    records = []
    for i in range(FIT_APP_VIEWS):
        ang = math.radians(45.0 + TRAIN_POSE_DEG * i)
        cam = look_camera(gt, (5.5 * math.sin(ang), 1.7, 5.5 * math.cos(ang)),
                          cfg.width / cfg.height, fov=60.0)
        with torch.no_grad():
            fb = gt.render_for_training(truth, cam.params(cfg.k_sigma, device=DEVICE), cfg)
        np.save(os.path.join(data, f"view_{i}.npy"), fb.cpu().numpy().transpose(1, 2, 0)[::-1])
        c2w = np.stack([cam.r_axis, -cam.u_axis, -cam.f_axis, cam.position], axis=1)
        records.append({"c2w": c2w.tolist(), "fov_y": 60.0, "near": 0.2, "far": 100.0,
                        "target": f"view_{i}.npy"})
    with open(os.path.join(data, "poses.json"), "w") as fh:
        json.dump(records, fh)
    ck, ply = os.path.join(root, "ck"), os.path.join(root, "fitted.ply")
    argv = [data, "--init", os.path.join(REPO, "data", "trained_500k.ply"),
            "--sh-degree", "1", "--steps", "40", "--densify-every", "10",
            "--opacity-reset-every", "0", "--holdout-every", "4"]
    t0 = time.perf_counter()
    rc, text = run_app(fit, argv + ["--checkpoint-dir", ck, "--checkpoint-every", "20",
                                    "--out", ply])
    fit_s = time.perf_counter() - t0
    log(text)
    check(rc == 0, f"fit-app: apps/fit exited {rc}")
    lines = text.splitlines()
    final = [line for line in lines if line.startswith("final: PSNR")]
    held = [line for line in lines if line.startswith("held-out: PSNR")]
    check(len(final) == 1 and len(held) == 1, "fit-app: no final and held-out PSNR lines")
    check(f"wrote {ply}" in lines and os.path.isfile(ply), "fit-app: no PLY written")
    n_out = gt.load_ply(ply, max_sh_degree=1, device=DEVICE).num_gaussians
    check(n_out == scene.num_gaussians, f"fit-app: the PLY holds {n_out} splats")
    check(sorted(os.listdir(ck)) == ["step_000020", "step_000040"],
          f"fit-app: checkpoints {os.listdir(ck)}")
    t0 = time.perf_counter()
    rc_r, text_r = run_app(fit, argv + ["--resume", os.path.join(ck, "step_000020"),
                                        "--out", os.path.join(root, "resumed.ply")])
    resume_s = time.perf_counter() - t0
    log(text_r)
    check(rc_r == 0, f"fit-app: apps/fit --resume exited {rc_r}")
    t0 = time.perf_counter()
    rc_t, text_t = run_app(train_test, [])
    train_test_s = time.perf_counter() - t0
    log(text_t)
    check(rc_t == 0, f"fit-app: apps/train_test exited {rc_t}")
    shutil.rmtree(root)
    res = {"fit_app": f"apps/fit {' '.join(argv[1:])} on {FIT_APP_VIEWS} views",
           "poses_dataset": data,
           "final": final[0], "held_out": held[0], "ply_gaussians": n_out,
           "fit_s": fit_s, "resumed_fit_s": resume_s,
           "resumed_final": [l for l in text_r.splitlines() if l.startswith("final")],
           "train_test_s": train_test_s, "train_test": text_t.splitlines(),
           "card": card}
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


# ----------------------------------------------------------- capture phases
def capture_orbit(gt, n, aspect, offset=0.0, fov=60.0):
    """``n`` cameras on a circle of radius 5.5 around the origin at
    heights 1.0 and 2.4 in turn (tools/make_capture_demo.py's rig)."""
    cams = []
    for i in range(n):
        ang = 2.0 * math.pi * (i + offset) / n
        cams.append(look_camera(gt, (5.5 * math.sin(ang), (1.0, 2.4)[i % 2],
                                     5.5 * math.cos(ang)), aspect, fov=fov))
    return cams


def db(p):
    """A psnr_t value as a number for a gate."""
    return math.inf if p == "inf" else p


def ulp_diff(torch, a, b):
    """(count, largest) of the ulp distances between two f32 tensors."""
    d = (a.view(torch.int32).to(torch.int64) - b.view(torch.int32).to(torch.int64)).abs()
    return int((d > 0).sum()), int(d.max()) if d.numel() else 0


def phase_native_io(torch, gt, big, card):
    """The native readers on the card's host: data/trained_500k.ply and
    data/trained_100k.ply loaded onto the card through the C++ reader (the
    default) and through the NumPy reader, in turns (native, NumPy, NumPy,
    native), each load timed on the host clock; positions, SH and
    quaternions bit-equal between the two, opacity and scales within
    NATIVE_MAX_ULP. One 1920×1080 frame of the natively loaded trained_500k
    and the bench_3m frame; the emission probes (render.area_histogram,
    render.emission_total) equal to each frame's stats, their ms beside the
    frame's (three timed frames of each; the compositor's launches counted
    over all eight frames). An ascii and
    a truncated PLY raise ValueError."""
    import numpy as np

    from gaussianrenderer_tpu_torch import render

    loads, native = {}, {}
    for name in ("trained_500k", "trained_100k"):
        path = os.path.join(REPO, "data", f"{name}.ply")
        ms = {True: [], False: []}
        for use_native in (True, False, False, True):
            scene, t = host_ms(torch, lambda: gt.load_ply(
                path, max_sh_degree=None, use_native=use_native, device=DEVICE))
            ms[use_native].append(t)
            if use_native:
                native[name] = scene
            else:
                numpy_scene = scene
        row = {"gaussians": native[name].num_gaussians, "sh_degree": native[name].sh_degree,
               "native_ms": ms[True], "numpy_ms": ms[False]}
        for f in ("positions", "sh", "quats"):
            a, b = getattr(native[name], f), getattr(numpy_scene, f)
            check(a.device.type == DEVICE and torch.equal(a.view(torch.int32),
                                                          b.view(torch.int32)),
                  f"native-io: {name} {f} differs between the native and the NumPy load")
        for f in ("opacity", "scales"):
            count, largest = ulp_diff(torch, getattr(native[name], f), getattr(numpy_scene, f))
            row[f"{f}_ulp_differing"], row[f"{f}_ulp_max"] = count, largest
            check(largest <= NATIVE_MAX_ULP, f"native-io: {name} {f} {largest} ulp apart")
        loads[name] = row
        del numpy_scene

    scene500 = native["trained_500k"]
    cfg500 = gt.RenderConfig(height=NATIVE_H, width=NATIVE_W, sh_degree=scene500.sh_degree)
    frames = {"trained_500k": (scene500, look_camera(gt, (3.9, 1.7, 3.9), NATIVE_W / NATIVE_H),
                               cfg500),
              "bench_3m": big}
    timed = 3
    gt.composite_tiles_packed.launches = 0
    rendered = {}
    for label, (scene, cam, cfg) in frames.items():
        camp = cam.params(cfg.k_sigma, device=DEVICE)
        (fb, stats), _ = host_ms(torch, lambda: gt.render_frame(scene, camp, cfg))
        rendered[label] = (camp, fb, stats)
    probes = {}
    for label, (scene, cam, cfg) in frames.items():
        camp, fb, stats = rendered[label]
        check(fb.shape == (3, cfg.height, cfg.width) and bool(torch.isfinite(fb).all())
              and 0.0 < float(fb.mean()) < 1.0, f"native-io: {label} frame")
        hist = render.area_histogram(scene, camp, cfg)
        total = render.emission_total(scene, camp, cfg)
        check(hist.dtype == np.int64
              and np.array_equal(hist, stats.area_hist.cpu().numpy()),
              f"native-io: {label} area_histogram {hist.tolist()} != stats.area_hist")
        check(total == int(stats.num_instances),
              f"native-io: {label} emission_total {total} != {int(stats.num_instances)}")
        t = {"frame": [], "area_histogram": [], "emission_total": []}
        for _ in range(timed):
            for key, fn in (("frame", lambda: gt.render_frame(scene, camp, cfg)),
                            ("area_histogram", lambda: render.area_histogram(scene, camp, cfg)),
                            ("emission_total", lambda: render.emission_total(scene, camp, cfg))):
                t[key].append(host_ms(torch, fn)[1])
        probes[label] = {"num_instances": total, "num_culled": int(stats.num_culled),
                         "area_hist": hist.tolist(),
                         **{f"{k}_ms_median": statistics.median(v) for k, v in t.items()},
                         **{f"{k}_ms_all": v for k, v in t.items()}}
    # Every frame of the phase, the timed ones included; the probes launch
    # no compositor.
    launches = gt.composite_tiles_packed.launches
    check(launches == len(frames) * (1 + timed),
          f"native-io: {launches} compositor launches")
    check(probes["trained_500k"]["num_instances"] == REF_COUNTS["trained_500k"]["num_instances"],
          f"native-io: trained_500k instances {probes['trained_500k']['num_instances']}")

    d = fit_dir("chip_smoke_native")
    bad = {"ascii": os.path.join(d, "ascii.ply"), "truncated": os.path.join(d, "trunc.ply")}
    with open(bad["ascii"], "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\n"
                "property float y\nproperty float z\nend_header\n0 0 0\n")
    with open(os.path.join(REPO, "data", "trained_100k.ply"), "rb") as f:
        data = f.read()
    with open(bad["truncated"], "wb") as f:
        f.write(data[: len(data) - 1000])
    raised = {}
    for kind, path in bad.items():
        try:
            gt.load_ply(path, device=DEVICE)
            raised[kind] = None
        except ValueError as e:
            raised[kind] = str(e)
        check(raised[kind] is not None, f"native-io: the {kind} PLY loaded")
    # An index the C++ reader would write past its buffer with: the NumPy
    # reader loads the file instead.
    names = (["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2", "opacity"]
             + [f"scale_{i}" for i in range(4)] + [f"rot_{i}" for i in range(4)])
    unsafe = os.path.join(d, "scale_3.ply")
    with open(unsafe, "wb") as f:
        f.write(("\n".join(["ply", "format binary_little_endian 1.0", "element vertex 64"]
                           + [f"property float {n}" for n in names] + ["end_header"])
                 + "\n").encode())
        f.write(np.random.default_rng(15).normal(0, 1, (64, len(names)))
                .astype("<f4").tobytes())
    a, b = (gt.load_ply(unsafe, use_native=flag, device=DEVICE) for flag in (True, False))
    check(all(torch.equal(getattr(a, f), getattr(b, f)) for f in
              ("positions", "sh", "opacity", "scales", "quats")),
          "native-io: the scale_3 PLY did not load as the NumPy reader loads it")
    shutil.rmtree(d)
    res = {"native_io": loads, "probes": probes, "kernel_launches": launches,
           "bad_ply_errors": raised, "unsafe_header_loaded_by_numpy": True, "card": card}
    out(res)
    return res


def phase_formats_2m(torch, gt, card):
    """data/trained_2m.gsz (the repo's largest scene, 1,999,994 splats)
    loaded by load_scene onto the card; 10 frames of an orbit at 1920×1080
    through render_frame (the compositor's launches counted over them);
    the compositor against its plain version on 32 tiles of the first
    frame; then the scene written and reloaded as q16 .gsz, q8 .gsz and
    .splat, each save and load timed and each reload's first frame
    scored against the original's (q16 > 55 dB; .splat > 35 dB at SH
    degree 0; q8 printed)."""
    from gaussianrenderer_tpu_torch.ops.cuda.tile_render2 import (
        composite_tiles_packed_plain,
    )
    from gaussianrenderer_tpu_torch.scene import compact

    comp = gt.composite_tiles_packed
    scene, load_ms = host_ms(torch, lambda: gt.load_scene(SCENE_2M, max_sh_degree=None,
                                                          device=DEVICE))
    cfg = gt.RenderConfig(height=FORMATS_H, width=FORMATS_W, sh_degree=scene.sh_degree,
                          compositor="packed")
    cams = [look_camera(gt, (5.515 * math.sin(a), 1.7, 5.515 * math.cos(a)),
                        FORMATS_W / FORMATS_H)
            for a in (math.radians(45.0 + 36.0 * i) for i in range(FORMATS_FRAMES))]
    camps = [c.params(cfg.k_sigma, device=DEVICE) for c in cams]
    comp.launches = gt.table_lookup.launches = 0
    gt.render_frame(scene, camps[0], cfg)  # warm-up
    frame_ms, instances, fbs = [], [], []
    for camp in camps:
        (fb, st), ms = host_ms(torch, lambda: gt.render_frame(scene, camp, cfg))
        frame_ms.append(ms)
        instances.append(int(st.num_instances))
        fbs.append(fb)
    launches = comp.launches
    check(launches == FORMATS_FRAMES + 1 and gt.table_lookup.launches == 0,
          f"formats-2m: {launches} compositor and {gt.table_lookup.launches} lookup launches")
    for i, fb in enumerate(fbs):
        check(fb.shape == (3, FORMATS_H, FORMATS_W) and bool(torch.isfinite(fb).all())
              and 0.0 < float(fb.mean()) < 1.0, f"formats-2m: frame {i}")
    ref = fbs[0]
    del fbs

    inst = packed_frame(gt, scene, cams[0], cfg, False)
    max_err, tiles, _, _ = compare_frame_tiles(torch, gt, inst, cfg, "trained_2m 1080p")
    kw = comp_kwargs(cfg, False)
    kernel_ms = cuda_ms(torch, lambda: comp(inst.packed_feats, inst.tile_start,
                                            inst.tile_count, **kw), 5)
    plain_ms = cuda_ms(torch, lambda: composite_tiles_packed_plain(
        inst.packed_feats, inst.tile_start, inst.tile_count, tiles=tiles, **kw), 1)
    bounds = compositor_bounds(torch, inst, cfg)
    del inst

    d = fit_dir("chip_smoke_formats")
    cfg0 = dataclasses.replace(cfg, sh_degree=0)
    ref0 = gt.render_frame(scene, camps[0], cfg0)[0]
    formats = {}
    for fmt, ext, save in (("q16", ".gsz", lambda sc, p: compact.save_compact(sc, p, "q16")),
                           ("q8", ".gsz", lambda sc, p: compact.save_compact(sc, p, "q8")),
                           ("splat", ".splat", compact.save_splat)):
        path = os.path.join(d, f"trained_2m_{fmt}{ext}")
        _, save_ms = host_ms(torch, lambda: save(scene, path))
        back, reload_ms = host_ms(torch, lambda: gt.load_scene(path, max_sh_degree=None,
                                                              device=DEVICE))
        row = {"bytes": os.path.getsize(path), "gaussians": back.num_gaussians,
               "save_ms": save_ms, "load_ms": reload_ms,
               "psnr_db": psnr_t(gt.render_frame(back, camps[0], cfg)[0], ref)}
        if fmt == "splat":
            row["psnr_db_sh0"] = psnr_t(gt.render_frame(back, camps[0], cfg0)[0], ref0)
        formats[fmt] = row
        del back
        os.remove(path)
    shutil.rmtree(d)
    res = {
        "formats": "data/trained_2m.gsz",
        "gaussians": scene.num_gaussians,
        "sh_degree": scene.sh_degree,
        "load_ms": load_ms,
        "resolution": f"{FORMATS_W}x{FORMATS_H}",
        "frame_ms_median": statistics.median(frame_ms),
        "frame_ms_all": frame_ms,
        "num_instances_median": int(statistics.median(instances)),
        "num_instances_all": instances,
        "kernel_launches": launches,
        "kernel_ms_frame0": kernel_ms,
        "plain_ms_32_tiles": plain_ms,
        "kernel_vs_plain_max_abs": max_err,
        **bounds,
        "formats_saved_and_reloaded": formats,
        "card": card,
    }
    out(res)
    check(scene.num_gaussians == SCENE_2M_SPLATS, f"formats-2m: {scene.num_gaussians} splats")
    check(db(formats["q16"]["psnr_db"]) > FORMATS_Q16_MIN_PSNR,
          f"formats-2m: q16 reload at {formats['q16']['psnr_db']} dB")
    check(db(formats["splat"]["psnr_db_sh0"]) > FORMATS_SPLAT_MIN_PSNR,
          f"formats-2m: .splat reload at {formats['splat']['psnr_db_sh0']} dB (SH 0)")
    check(all(r["gaussians"] == scene.num_gaussians for r in formats.values()),
          f"formats-2m: reloaded counts {formats}")
    return res


def app_lines(text, prefix):
    return [line for line in text.splitlines() if line.startswith(prefix)]


def train_counts(tt):
    return {"tile_train_fwd": tt.train_forward.launches,
            "tile_train_bwd": tt.train_backward.launches}


def count_diff(after, before):
    return {k: after[k] - before[k] for k in after}


def run_eval(eval_app, argv, label):
    """apps/eval with ``argv``: (its JSON report, wall seconds); checks
    exit 0 and a finite PSNR."""
    t0 = time.perf_counter()
    rc, text = run_app(eval_app, argv)
    secs = time.perf_counter() - t0
    log(text)
    check(rc == 0, f"{label}: apps/eval exited {rc}")
    report = json.loads(text.strip().splitlines()[-1])
    check(math.isfinite(report["psnr"]) and math.isfinite(report["ssim"]),
          f"{label}: apps/eval report {report}")
    return report, secs


def phase_colmap_fit(torch, gt, card):
    """A COLMAP capture: 12 orbit views of data/trained_surface_100k.gsz at
    1280×720 rendered by the port and written with save_colmap_workspace,
    with a points3D cloud of 20,000 of the scene's positions and their DC
    colours; apps/fit on it (SfM init, the default for COLMAP), apps/eval
    of the fitted PLY through the train and the packed path, apps/edit to
    a pruned .gsz and apps/eval of that. Each app's wall time, the
    points3D.bin read time (and a capture-scale 10⁶-point file's), and the
    kernels' launches in the apps (counts set to 0 just before). Both
    points3D.bin files are read by the native reader and by the Python
    loop: arrays equal, each read timed."""
    import numpy as np

    from gaussianrenderer_tpu_torch.apps import edit as edit_app
    from gaussianrenderer_tpu_torch.apps import eval as eval_app
    from gaussianrenderer_tpu_torch.apps import fit
    from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt
    from gaussianrenderer_tpu_torch.ops.sh import SH_C0
    from gaussianrenderer_tpu_torch.scene import colmap

    root = fit_dir("chip_smoke_colmap")
    data = os.path.join(root, "dataset")
    scene = gt.load_scene(SCENE_SURFACE, max_sh_degree=None, device=DEVICE)
    cfg = gt.RenderConfig(height=COLMAP_H, width=COLMAP_W, sh_degree=scene.sh_degree)
    cams = capture_orbit(gt, COLMAP_VIEWS, COLMAP_W / COLMAP_H)
    frames = [gt.framebuffer_to_image(gt.render_frame(scene, c.params(cfg.k_sigma, device=DEVICE),
                                                      cfg)[0]) for c in cams]
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.choice(scene.num_gaussians, COLMAP_POINTS, replace=False))
    xyz = scene.positions[idx.to(DEVICE)].cpu().numpy()
    rgb = (0.5 + SH_C0 * scene.sh[idx.to(DEVICE), :3]).clamp(0.0, 1.0).cpu().numpy()
    colmap.save_colmap_workspace(data, cams, frames, points_xyz=xyz, points_rgb=rgb)
    del frames
    # Each file read by the native reader (the default) and by the Python
    # loop (the old fields' meaning), in that order; the arrays equal.
    read_s = {}
    big = os.path.join(root, "points3D_capture.bin")
    colmap.write_points3d_bin(big, rng.normal(0, 3, (POINTS_READ_CAPTURE, 3)),
                              rng.integers(0, 256, (POINTS_READ_CAPTURE, 3), dtype=np.uint8))
    for label, path, n in (("", os.path.join(data, "sparse", "0", "points3D.bin"),
                            COLMAP_POINTS),
                           ("_capture", big, POINTS_READ_CAPTURE)):
        got = {}
        for use_native in (True, False):
            t0 = time.perf_counter()
            got[use_native] = colmap.read_points3d_bin(path, use_native=use_native)
            read_s[f"points3d_read{label}{'_native' if use_native else ''}_s"] = (
                time.perf_counter() - t0)
        check(got[True][0].shape == (n, 3), f"colmap-fit: points {got[True][0].shape}")
        check(all(a.dtype == b.dtype and np.array_equal(a, b)
                  for a, b in zip(got[True], got[False])),
              f"colmap-fit: native and loop points3D reads of {n} points differ")
        del got
    os.remove(big)

    ply, gsz = os.path.join(root, "fitted.ply"), os.path.join(root, "out.gsz")
    held = ["--holdout-every", "4"]
    tt.train_forward.launches = tt.train_backward.launches = 0
    gt.composite_tiles_packed.launches = 0
    t0 = time.perf_counter()
    rc, text = run_app(fit, [data, "--n", str(COLMAP_FIT_N), "--steps", str(COLMAP_FIT_STEPS),
                             "--densify-every", "20", *held, "--out", ply])
    fit_s = time.perf_counter() - t0
    log(text)
    check(rc == 0, f"colmap-fit: apps/fit exited {rc}")
    sfm = app_lines(text, "SfM init:")
    check(sfm == [f"SfM init: {COLMAP_POINTS} points -> {COLMAP_FIT_N} splats"],
          f"colmap-fit: SfM init lines {sfm}")
    final, heldout = app_lines(text, "final: PSNR"), app_lines(text, "held-out: PSNR")
    check(len(final) == 1 and len(heldout) == 1 and os.path.isfile(ply),
          "colmap-fit: no final/held-out lines or no PLY")
    n_train, n_held = COLMAP_VIEWS - len(range(0, COLMAP_VIEWS, 4)), len(range(0, COLMAP_VIEWS, 4))
    fit_calls = train_counts(tt)
    check(fit_calls == {"tile_train_fwd": COLMAP_FIT_STEPS + n_train + n_held,
                        "tile_train_bwd": COLMAP_FIT_STEPS},
          f"colmap-fit: train kernel calls {fit_calls} in apps/fit")
    before = train_counts(tt)
    rep_train, eval_train_s = run_eval(eval_app, [ply, data, *held], "colmap-fit train")
    eval_calls = count_diff(train_counts(tt), before)
    check(eval_calls == {"tile_train_fwd": n_held, "tile_train_bwd": 0},
          f"colmap-fit: apps/eval --path train kernel calls {eval_calls}")
    rep_packed, eval_packed_s = run_eval(eval_app, [ply, data, *held, "--path", "packed"],
                                         "colmap-fit packed")
    packed_launches = gt.composite_tiles_packed.launches
    check(rep_packed["overflow_views"] == 0 and packed_launches == n_held,
          f"colmap-fit: packed report {rep_packed}, {packed_launches} compositor launches")
    t0 = time.perf_counter()
    rc, text_e = run_app(edit_app, [gsz, ply, "--min-opacity", "0.005"])
    edit_s = time.perf_counter() - t0
    log(text_e)
    check(rc == 0 and os.path.isfile(gsz), f"colmap-fit: apps/edit exited {rc}")
    rep_gsz, eval_gsz_s = run_eval(eval_app, [gsz, data, *held], "colmap-fit edited")
    launches = {**train_counts(tt), "tile_render2": gt.composite_tiles_packed.launches}
    shutil.rmtree(root)
    res = {
        "colmap_fit": (f"{COLMAP_VIEWS} views of data/trained_surface_100k.gsz at "
                       f"{COLMAP_W}x{COLMAP_H}, {COLMAP_POINTS} SfM points"),
        "fit_argv": (f"--n {COLMAP_FIT_N} --steps {COLMAP_FIT_STEPS} --densify-every 20 "
                     "--holdout-every 4"),
        "sfm_line": sfm[0], "final": final[0], "held_out": heldout[0],
        "eval_train": rep_train, "eval_packed": rep_packed,
        "edit": app_lines(text_e, "prune:") + app_lines(text_e, "wrote"),
        "eval_edited_gsz": rep_gsz,
        "edited_psnr_change_db": rep_gsz["psnr"] - rep_train["psnr"],
        "app_s": {"fit": fit_s, "eval_train": eval_train_s, "eval_packed": eval_packed_s,
                  "edit": edit_s, "eval_gsz": eval_gsz_s},
        **read_s,
        "points3d_capture_points": POINTS_READ_CAPTURE,
        "kernel_launches": launches,
        "card": card,
    }
    out(res)
    return res


def phase_blender_fit(torch, gt, card):
    """A NeRF-synthetic capture: transforms_train.json (12 views) and
    transforms_test.json (4 views) with RGBA PNGs of
    data/trained_surface_100k.gsz at 800×800 (alpha from the render's
    alpha row, straight colour), ``camera_angle_x`` intrinsics; apps/fit
    refining the scene over a white background, apps/eval of the test
    split over white."""
    import numpy as np
    from PIL import Image

    from gaussianrenderer_tpu_torch.apps import eval as eval_app
    from gaussianrenderer_tpu_torch.apps import fit
    from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt

    root = fit_dir("chip_smoke_blender")
    data = os.path.join(root, "dataset")
    scene = gt.load_scene(SCENE_SURFACE, max_sh_degree=None, device=DEVICE)
    cfg = gt.RenderConfig(height=BLENDER_SIZE, width=BLENDER_SIZE, sh_degree=scene.sh_degree,
                          output_alpha=True)
    fov = 60.0
    for split, n, offset in (("train", BLENDER_TRAIN, 0.0), ("test", BLENDER_TEST, 0.5)):
        os.makedirs(os.path.join(data, split))
        frames = []
        for i, cam in enumerate(capture_orbit(gt, n, 1.0, offset=offset, fov=fov)):
            fb, _ = gt.render_frame(scene, cam.params(cfg.k_sigma, device=DEVICE), cfg)
            alpha = fb[3:4]
            straight = torch.where(alpha > 0, fb[:3] / alpha.clamp_min(1e-12), 0.0)
            rgba = torch.cat([straight.clamp(0.0, 1.0), alpha.clamp(0.0, 1.0)])
            img = (rgba.permute(1, 2, 0).flip(0) * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
            Image.fromarray(img, "RGBA").save(os.path.join(data, split, f"r_{i}.png"))
            # OpenGL camera→world: columns right, up, backward (f_axis), position.
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = cam.r_axis, cam.u_axis, cam.f_axis
            c2w[:3, 3] = cam.position
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(data, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": math.radians(fov), "frames": frames}, fh)
    ply = os.path.join(root, "fitted.ply")
    tt.train_forward.launches = tt.train_backward.launches = 0
    t0 = time.perf_counter()
    rc, text = run_app(fit, [data, "--init", SCENE_SURFACE, "--background", "white",
                             "--steps", str(BLENDER_FIT_STEPS), "--out", ply])
    fit_s = time.perf_counter() - t0
    log(text)
    check(rc == 0 and os.path.isfile(ply), f"blender-fit: apps/fit exited {rc}")
    final = app_lines(text, "final: PSNR")
    views_line = text.splitlines()[0]
    check(len(final) == 1 and views_line == f"{BLENDER_TRAIN} train / 0 held-out views at "
          f"{BLENDER_SIZE}x{BLENDER_SIZE}", f"blender-fit: apps/fit lines {views_line!r} {final}")
    fit_calls = train_counts(tt)
    check(fit_calls == {"tile_train_fwd": BLENDER_FIT_STEPS + BLENDER_TRAIN,
                        "tile_train_bwd": BLENDER_FIT_STEPS},
          f"blender-fit: train kernel calls {fit_calls} in apps/fit")
    rep, eval_s = run_eval(eval_app, [ply, data, "--split", "test", "--background", "white"],
                           "blender-fit")
    check(rep["views"] == BLENDER_TEST, f"blender-fit: eval report {rep}")
    launches = train_counts(tt)
    shutil.rmtree(root)
    res = {
        "blender_fit": (f"{BLENDER_TRAIN} train + {BLENDER_TEST} test RGBA views of "
                        f"data/trained_surface_100k.gsz at {BLENDER_SIZE}x{BLENDER_SIZE}"),
        "fit_argv": f"--init data/trained_surface_100k.gsz --background white --steps "
                    f"{BLENDER_FIT_STEPS}",
        "final": final[0],
        "loss": app_lines(text, "loss:"),
        "eval_test_split": rep,
        "app_s": {"fit": fit_s, "eval": eval_s},
        "kernel_launches": launches,
        "card": card,
    }
    out(res)
    return res


# ------------------------------------------------------------- viewer phase
def http_get(url, timeout=VIEWER_HTTP_TIMEOUT):
    from urllib.request import urlopen

    with urlopen(url, timeout=timeout) as r:
        return r.read()


def decode_image(data):
    """(H, W, 3) uint8 of an encoded JPEG, BMP or PNG frame."""
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def start_viewer_app(module, argv, log_path):
    """``python -m module argv`` from the checkout, stdout piped and read
    by a thread into a queue, stderr to ``log_path``."""
    import queue
    import threading

    err = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, "-m", module, *argv], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=err, text=True)
    lines = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    return proc, lines, err


def viewer_app_url(proc, lines, log_path, timeout=VIEWER_APP_START_S):
    """The URL of a served app's ``viewer: <url>`` line."""
    import queue

    deadline = time.monotonic() + timeout
    while True:
        try:
            line = lines.get(timeout=max(deadline - time.monotonic(), 0.1))
        except queue.Empty:
            line = None
        if line is None:
            with open(log_path) as fh:
                log(fh.read()[-4000:])
            check(False, f"viewer-2m: {proc.args[2]} printed no viewer line "
                  f"(exit {proc.poll()})")
        if line.startswith("viewer: "):
            return line.split()[1]


def stop_process(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def depth_gray_numpy(fb, flip_y):
    """The JAX Canvas's NumPy depth-view image of a 5-row framebuffer."""
    import numpy as np

    fb = fb.cpu().numpy()
    alpha, depth = fb[3], fb[4]
    covered = alpha > 0.05
    nd = np.where(covered, depth / np.maximum(alpha, 1e-6), 0.0)
    vis = nd[covered]
    lo = float(vis.min()) if vis.size else 0.0
    hi = float(vis.max()) if vis.size else 1.0
    gray = np.where(covered, (nd - lo) / max(hi - lo, 1e-6), 0.0).astype(np.float32)
    img = (np.clip(gray, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    img = np.repeat(img[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img[::-1] if flip_y else img)


def draw_split_ms(torch, canvas, reps=5):
    """Medians over ``reps`` frames of where a /frame request's time goes
    after its ``render()``: the host time of ``canvas.render()`` (as
    /frame's dispatch_ms, here on the main thread), the card's work left
    when it returns (one synchronize), then the parts of
    ``render.framebuffer_to_image``: its uint8 conversion on the card
    (``framebuffer_to_uint8``, synchronized), the copy to the host and
    the host's flipped contiguous copy; beside them the whole
    ``canvas.draw()`` right after a ``render()``, as /frame's
    fetch_draw_ms times it; and whether the card's uint8 image is
    contiguous."""
    import numpy as np

    from gaussianrenderer_tpu_torch.render import framebuffer_to_uint8

    parts = {k: [] for k in ("render_ms", "device_tail_ms", "device_ms", "copy_ms",
                             "host_ms", "draw_ms")}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        canvas.render()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        parts["render_ms"].append((t1 - t0) * 1e3)
        parts["device_tail_ms"].append((time.perf_counter() - t1) * 1e3)
        img, ms = host_ms(torch, lambda: framebuffer_to_uint8(canvas._fb))
        parts["device_ms"].append(ms)
        t0 = time.perf_counter()
        arr = img.cpu().numpy()
        t1 = time.perf_counter()
        np.ascontiguousarray(arr[::-1])
        parts["copy_ms"].append((t1 - t0) * 1e3)
        parts["host_ms"].append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        canvas.render()
        t0 = time.perf_counter()
        canvas.draw()
        parts["draw_ms"].append((time.perf_counter() - t0) * 1e3)
    res = {k: statistics.median(v) for k, v in parts.items()}
    res["device_image_contiguous"] = img.is_contiguous()
    return res


def phase_viewer_2m(torch, gt, card, poses_dir):
    """The viewer on the card: a 1080p Canvas holding data/trained_2m.gsz
    (prewarm, equality with render_frame, one compositor launch a frame,
    a synchronized frame median), then the browser viewer over localhost
    HTTP (the PNG frame equal to draw(), 10 timed /frame requests, a
    30-part /stream while /orbit is poked, the depth view, k-sigma and
    fov, zoom, a resize to 720p, uploads of trained_500k.ply and
    trained_2m.gsz and a bad name, /stats keys, a 4D scene's time scrub);
    apps/cull_sort_test on trained_500k.ply for 120 frames beside a
    synchronized median; apps/cull_sort_test --serve and
    apps/window_test as served processes; apps/fit --serve with its
    monitor polled while it fits."""
    import threading
    from http.client import HTTPConnection

    import numpy as np

    from gaussianrenderer_tpu_torch import viewer, web_viewer
    from gaussianrenderer_tpu_torch.apps import cull_sort_test, fit
    from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt

    root = fit_dir("chip_smoke_viewer")
    comp = gt.composite_tiles_packed
    procs = []
    try:
        comp.launches = tt.train_forward.launches = tt.train_backward.launches = 0
        canvas = viewer.Canvas(VIEWER_H, VIEWER_W, device=DEVICE)
        canvas.init(prewarm=True, resize_buckets=(VIEWER_RESIZE,))
        canvas._prewarm_thread.join(timeout=600)
        check(not canvas._prewarm_thread.is_alive() and canvas._prewarm_error is None,
              f"viewer-2m: prewarm {canvas._prewarm_error!r}")
        _, load_ms = host_ms(torch, lambda: canvas.load_gaussians(SCENE_2M))
        check(canvas.scene.num_gaussians == SCENE_2M_SPLATS,
              f"viewer-2m: {canvas.scene.num_gaussians} splats")
        cam = canvas.camera
        cam.set_position(list(VIEWER_POSE))
        cam.set_look_at([0.0, 0.0, 0.0])
        cam.set_clipping_planes(0.2, 100.0)
        cam.set_aspect_ratio(VIEWER_W / VIEWER_H)
        canvas.set_fov(70.0)

        # Equality with render_frame, one launch a frame, frame time.
        fb, st = canvas.render()
        ref, ref_st = gt.render_frame(canvas.scene, cam.params(canvas.settings.k_sigma,
                                                               device=DEVICE), canvas.cfg)
        check(torch.equal(fb, ref) and int(st.num_instances) == int(ref_st.num_instances),
              "viewer-2m: the Canvas frame differs from render_frame's")
        before = comp.launches
        frame_ms = [host_ms(torch, canvas.render)[1] for _ in range(VIEWER_FRAMES)]
        check(comp.launches - before == VIEWER_FRAMES,
              f"viewer-2m: {comp.launches - before} compositor launches in "
              f"{VIEWER_FRAMES} frames")

        server = web_viewer.make_server(canvas, port=0)
        port = server.server_address[1]
        base = f"http://127.0.0.1:{port}"
        serving = threading.Thread(target=server.serve_forever, daemon=True)
        serving.start()
        try:
            check(b"gaussianrenderer_tpu_torch viewer" in http_get(base + "/"),
                  "viewer-2m: page")
            png = decode_image(http_get(base + "/frame?fmt=png"))
            check(png.shape == (VIEWER_H, VIEWER_W, 3)
                  and np.array_equal(png, canvas.draw()),
                  "viewer-2m: /frame?fmt=png differs from draw()")
            stages, wall_ms = [], []
            for _ in range(VIEWER_FRAMES):
                t0 = time.perf_counter()
                body = http_get(base + "/frame")
                wall_ms.append((time.perf_counter() - t0) * 1e3)
                stages.append(json.loads(http_get(base + "/stats"))["frame"])
            check(decode_image(body).shape == (VIEWER_H, VIEWER_W, 3),
                  "viewer-2m: /frame size")
            frame_stage_ms = {k: statistics.median(s[k] for s in stages)
                              for k in ("dispatch_ms", "fetch_draw_ms", "encode_ms",
                                        "total_ms")}
            draw_split = draw_split_ms(torch, canvas)

            # The push stream while a second thread pokes /orbit.
            got = {}

            def reader():
                t0 = time.perf_counter()
                got["data"] = http_get(base + f"/stream?frames={VIEWER_STREAM_FRAMES}")
                got["s"] = time.perf_counter() - t0

            rt = threading.Thread(target=reader)
            rt.start()
            pokes = 0
            while rt.is_alive():
                http_get(base + "/orbit?dx=4&dy=0")
                pokes += 1
                rt.join(timeout=0.01)
            rt.join(timeout=VIEWER_HTTP_TIMEOUT)
            check("data" in got, "viewer-2m: the stream returned nothing")
            parts = got["data"].count(b"--grframe")
            check(parts == VIEWER_STREAM_FRAMES,
                  f"viewer-2m: {parts} stream parts of {VIEWER_STREAM_FRAMES}")
            stream_stages = json.loads(http_get(base + "/stats"))["frame"]

            # The depth view: 5 rows, gray, covered pixels lit, the NumPy form.
            http_get(base + "/set?view=depth")
            depth_img = decode_image(http_get(base + "/frame?fmt=png"))
            check(canvas._fb.shape[0] == 5, f"viewer-2m: depth frame {canvas._fb.shape}")
            check(np.array_equal(depth_img[..., 0], depth_img[..., 1])
                  and np.array_equal(depth_img[..., 1], depth_img[..., 2])
                  and depth_img.max() > 0, "viewer-2m: depth image not gray or dark")
            depth_levels = int(np.abs(depth_img.astype(np.int16) - depth_gray_numpy(
                canvas._fb, canvas.settings.flip_y).astype(np.int16)).max())
            check(depth_levels <= DEPTH_VIEW_LEVELS,
                  f"viewer-2m: depth view {depth_levels} levels from the NumPy form")
            http_get(base + "/set?view=rgb")
            rgb = decode_image(http_get(base + "/frame?fmt=png"))
            http_get(base + "/set?k_sigma=1.5&fov=60")
            ks = decode_image(http_get(base + "/frame?fmt=png"))
            check(canvas.settings.k_sigma == 1.5 and canvas.settings.fov_y == 60.0
                  and not np.array_equal(rgb, ks), "viewer-2m: /set k_sigma, fov")
            http_get(base + "/zoom?d=0.5")
            zoomed = decode_image(http_get(base + "/frame?fmt=png"))
            check(not np.array_equal(ks, zoomed), "viewer-2m: /zoom")
            canvas.on_resize(*VIEWER_RESIZE)
            small = decode_image(http_get(base + "/frame?fmt=png"))
            check(small.shape == (*VIEWER_RESIZE, 3), f"viewer-2m: resized {small.shape}")

            # Uploads: the PLY, the .gsz, and a bad name.
            uploads = {}
            conn = HTTPConnection("127.0.0.1", port, timeout=VIEWER_HTTP_TIMEOUT)
            try:
                for path, want in ((SCENE_500K, None), (SCENE_2M, SCENE_2M_SPLATS),
                                   (None, None)):
                    name = os.path.basename(path) if path else ".bad"
                    data = b"x" if path is None else open(path, "rb").read()
                    t0 = time.perf_counter()
                    conn.request("POST", f"/load?name={name}", body=data,
                                 headers={"Content-Length": str(len(data))})
                    resp = conn.getresponse()
                    answer = resp.read()
                    uploads[name] = {"status": resp.status,
                                     "ms": (time.perf_counter() - t0) * 1e3}
                    if path is None:
                        check(resp.status == 400, f"viewer-2m: bad upload {resp.status}")
                        continue
                    n = json.loads(answer)["gaussians"]
                    uploads[name]["gaussians"] = n
                    check(resp.status == 200 and n == canvas.scene.num_gaussians
                          and (want is None or n == want), f"viewer-2m: upload {name} {answer}")
                    del data
            finally:
                conn.close()
            stats = json.loads(http_get(base + "/stats"))
            check(sorted(stats) == sorted(VIEWER_STATS_KEYS),
                  f"viewer-2m: /stats keys {sorted(stats)}")
            check(stats["gaussians"] == SCENE_2M_SPLATS, f"viewer-2m: /stats {stats}")

            # A 4D scene at 1080p: two times give two frames.
            canvas.on_resize(VIEWER_H, VIEWER_W)
            canvas.set_scene(gt.make_random_scene(VIEWER_4D_SPLATS, seed=0, spacetime=True,
                                                  device=DEVICE))
            times = []
            for t in ("0", "1"):
                http_get(base + f"/set?time={t}")
                times.append(decode_image(http_get(base + "/frame?fmt=png")))
            check(json.loads(http_get(base + "/stats"))["spacetime"] is True
                  and not np.array_equal(*times), "viewer-2m: the time scrub")
        finally:
            server.shutdown()
            server.server_close()
            serving.join(timeout=VIEWER_HTTP_TIMEOUT)
        canvas_frames = canvas.timer.frames
        del canvas

        # gr-render headless at its defaults, beside a synchronized median.
        shot = os.path.join(root, "gr_render.png")
        t0 = time.perf_counter()
        rc, text = run_app(cull_sort_test, [SCENE_500K, "--frames", str(GR_RENDER_FRAMES),
                                            "--screenshot", shot, "--device", DEVICE])
        gr_render_s = time.perf_counter() - t0
        log(text)
        ema = app_lines(text, "frame ")
        final = app_lines(text, "final:")
        check(rc == 0 and len(ema) == GR_RENDER_FRAMES // 60 and len(final) == 1
              and decode_image(open(shot, "rb").read()).shape == (1500, 2000, 3),
              f"viewer-2m: gr-render exited {rc} with {text!r}")
        session = cull_sort_test.session_canvas(2000, 1500, device=DEVICE)
        session.load_gaussians(SCENE_500K)
        session.render()
        gr_frame_ms = []
        for _ in range(VIEWER_FRAMES):
            session.camera.orbit(1.0, 0.0)
            gr_frame_ms.append(host_ms(torch, session.render)[1])
        session_frames = session.timer.frames
        del session

        # The served apps, started together after every timed frame: one
        # /frame each, then they stop.
        for module, argv in (
                ("gaussianrenderer_tpu_torch.apps.cull_sort_test", [SCENE_500K, "--serve",
                                                                    "--port", "0"]),
                ("gaussianrenderer_tpu_torch.apps.window_test", ["--port", "0"])):
            argv += ["--device", DEVICE]
            log_path = os.path.join(root, module.rsplit(".", 1)[1] + ".log")
            procs.append((module, log_path, *start_viewer_app(module, argv, log_path)))
        served = {}
        for module, log_path, proc, lines, err in procs:
            url = viewer_app_url(proc, lines, log_path)
            t0 = time.perf_counter()
            img = decode_image(http_get(url + "frame", timeout=VIEWER_APP_START_S))
            name = module.rsplit(".", 1)[1]
            served[name] = {"shape": list(img.shape),
                            "first_frame_ms": (time.perf_counter() - t0) * 1e3}
            want = (1500, 2000, 3) if name == "cull_sort_test" else (512, 512, 3)
            check(img.shape == want and img.max() > 0, f"viewer-2m: {name} /frame {img.shape}")
        for _, _, proc, _, _ in procs:
            stop_process(proc)

        # fit --serve: the monitor polled while the fit runs.
        monitors = []

        class Recorded(web_viewer.TrainMonitor):
            def start(self):
                monitors.append(self)
                return super().start()

        polled = {"steps": [], "frames": 0}
        done = threading.Event()

        def poll():
            while not done.is_set():
                if monitors:
                    try:
                        polled["steps"].append(
                            json.loads(http_get(monitors[0].url + "status"))["step"])
                        http_get(monitors[0].url + "frame")
                        polled["frames"] += 1
                    except OSError:  # 404 before the first snapshot
                        pass
                done.wait(0.1)

        poller = threading.Thread(target=poll)
        saved = web_viewer.TrainMonitor
        web_viewer.TrainMonitor = Recorded
        poller.start()
        before = {"fwd": tt.train_forward.launches, "bwd": tt.train_backward.launches}
        try:
            t0 = time.perf_counter()
            rc, text = run_app(fit, [poses_dir, "--init", SCENE_500K, "--sh-degree", "1",
                                     "--steps", str(VIEWER_FIT_STEPS), "--densify-every", "10",
                                     "--opacity-reset-every", "0", "--holdout-every", "4",
                                     "--serve", "0", "--serve-every",
                                     str(VIEWER_FIT_SERVE_EVERY),
                                     "--out", os.path.join(root, "fitted.ply"),
                                     "--device", DEVICE])
            fit_s = time.perf_counter() - t0
            done.set()
            poller.join(timeout=VIEWER_HTTP_TIMEOUT)
            log(text)
            check(rc == 0 and len(monitors) == 1, f"viewer-2m: apps/fit --serve exited {rc}")
            check(app_lines(text, "monitor: ") == [f"monitor: {monitors[0].url}"],
                  "viewer-2m: no monitor line")
            status = json.loads(http_get(monitors[0].url + "status"))
            snap = decode_image(http_get(monitors[0].url + "frame"))
            check(status["step"] == VIEWER_FIT_STEPS and status["total_steps"] == VIEWER_FIT_STEPS
                  and snap.shape == (TRAIN_H, TRAIN_W, 3), f"viewer-2m: monitor {status}")
        finally:
            done.set()
            poller.join(timeout=VIEWER_HTTP_TIMEOUT)
            web_viewer.TrainMonitor = saved
            for m in monitors:
                m.stop()
        with open(os.path.join(poses_dir, "poses.json")) as fh:
            views = len(json.load(fh))
        snapshots = VIEWER_FIT_STEPS // VIEWER_FIT_SERVE_EVERY + 1
        fit_calls = {"fwd": tt.train_forward.launches - before["fwd"],
                     "bwd": tt.train_backward.launches - before["bwd"]}
        check(fit_calls == {"fwd": VIEWER_FIT_STEPS + snapshots + views,
                            "bwd": VIEWER_FIT_STEPS},
              f"viewer-2m: train kernel calls {fit_calls} in apps/fit --serve")

    finally:
        for _, _, proc, _, err in procs:
            stop_process(proc)
            err.close()
    launches = {"tile_render2": comp.launches, "tile_train_fwd": tt.train_forward.launches,
                "tile_train_bwd": tt.train_backward.launches}
    # Every frame of the phase's canvases (and the one render_frame beside
    # them) launched the compositor once.
    frames = canvas_frames + GR_RENDER_FRAMES + session_frames + 1
    check(launches["tile_render2"] == frames,
          f"viewer-2m: {launches['tile_render2']} compositor launches for {frames} frames")
    shutil.rmtree(root)
    shutil.rmtree(poses_dir)
    res = {
        "viewer": (f"Canvas {VIEWER_W}x{VIEWER_H} on data/trained_2m.gsz from "
                   f"{VIEWER_POSE}, fov 70"),
        "load_ms": load_ms,
        "canvas_frame_ms_median": statistics.median(frame_ms),
        "canvas_frame_ms_all": frame_ms,
        "num_instances": int(st.num_instances),
        "frame_stage_ms_median": frame_stage_ms,
        "frame_wall_ms_median": statistics.median(wall_ms),
        "draw_split_ms_median": draw_split,
        "frame_format": stages[-1]["fmt"], "frame_bytes": stages[-1]["bytes"],
        "stream_parts": parts, "stream_s": got["s"],
        "stream_frames_per_s": parts / got["s"], "stream_orbit_pokes": pokes,
        "stream_last_stages_ms": stream_stages,
        "depth_view_levels_from_numpy": depth_levels,
        "uploads": uploads,
        "gr_render": {"lines": ema + final, "s": gr_render_s,
                      "synchronized_frame_ms_median": statistics.median(gr_frame_ms),
                      "synchronized_frame_ms_all": gr_frame_ms},
        "fit_serve": {"monitor_status": status, "polled_steps": sorted(set(polled["steps"])),
                      "polled_frames": polled["frames"], "s": fit_s,
                      "final": app_lines(text, "final:"), "train_kernel_calls": fit_calls},
        "served_apps": served,
        "kernel_launches": launches,
        "card": card,
    }
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


def gemm_counts(mm):
    """Launches of each GEMM route so far, by name."""
    return {"sm90": mm.launches_sm90, "packed": mm.launches_packed}


def gemm_case(torch, mm, name, a, b, kw):
    """One GEMM case: the kernel against its plain version, the launches
    of each kernel it made and, on a mismatch, the first (row, col) past
    the gate. Returns the case and the plain version's product."""
    from gaussianrenderer_tpu_torch.ops.cuda.matmul import matmul_blocked_plain

    before = gemm_counts(mm)
    got = mm(a, b, **kw)
    served = {k: v - before[k] for k, v in gemm_counts(mm).items()}
    want = matmul_blocked_plain(a, b, **kw)
    scale = float(want.abs().max())
    diff = (got - want).abs()
    rel = float(diff.max()) / scale
    bad = (diff > GEMM_MAX_REL * scale).nonzero()
    return {"case": name, "kernel": [k for k, v in served.items() if v], "launches": served,
            "max_rel_err": rel, "max_abs_err": rel * scale,
            "first_mismatch": [int(v) for v in bad[0]] if bad.shape[0] else None}, want


def check_gemm_case(case, kernel):
    """The case went through ``kernel`` once and stays within the gate."""
    check(case["launches"] == {k: int(k == kernel) for k in case["launches"]},
          f"{case['case']}: launches {case['launches']}, not one of {kernel}")
    check(case["max_rel_err"] <= GEMM_MAX_REL,
          f"{case['case']}: kernel vs plain {case['max_rel_err']:.3g} of the largest entry, "
          f"first mismatch at (row, col) {case['first_mismatch']}")


def phase_gemm(torch, gt, card, n=GEMM_N):
    """The GEMM harness's path: the port's ``matrix_test`` at N on random
    and on ones inputs, both through the sm90 route, and at an odd N
    through the packed route (it checks the kernel against ``torch.mm`` and
    the ones closed form itself and exits 0 only if they hold); then the
    kernel against its plain version on the same random inputs, on ones,
    on the edge shapes and on a misaligned input, each through the route
    it must take; each route's, its plain version's and ``torch.mm``'s
    times (at the odd N in turns, and the kernels' device ms)."""
    from gaussianrenderer_tpu_torch.apps import matrix_test
    from gaussianrenderer_tpu_torch.ops.cuda import prng
    from gaussianrenderer_tpu_torch.ops.cuda.matmul import gemm_kernel, matmul_blocked_plain

    mm = gt.matmul_blocked
    # matrix_test's default blocking (a contract only: the kernels tile by
    # 128x256 and 128x128 whatever they are given).
    kw = dict(bm=min(512, n), bn=min(1024, n), bk=min(1024, n))
    blocks = [f"--{k}={v}" for k, v in kw.items()]
    okw = dict(bm=GEMM_ODD_BLOCK, bn=GEMM_ODD_BLOCK, bk=GEMM_ODD_BLOCK)
    odd_blocks = [f"--{k}={v}" for k, v in okw.items()]
    runs = {}
    launches = {"sm90": 0, "packed": 0}
    prng_before = prng.launches
    for label, argv, kernel in (
        ("random", ["--n", str(n)] + blocks, "sm90"),
        ("ones", ["--n", str(n), "--ones"] + blocks, "sm90"),
        (f"odd {GEMM_ODD_N}", ["--n", str(GEMM_ODD_N)] + odd_blocks, "packed"),
    ):
        mm.launches = mm.launches_sm90 = mm.launches_packed = 0
        rc, text = run_app(matrix_test, argv + ["--device", DEVICE])
        served = gemm_counts(mm)
        log(text.rstrip())
        out({"matrix_test": label, "launches": served})
        check(rc == 0 and "-> OK" in text, f"matrix_test {label}: exit {rc}: {text!r}")
        check(served[kernel] == mm.launches > 0,
              f"matrix_test {label}: launches {served}, not all through {kernel}")
        runs[label] = {"times": app_times(text), "stdout": text.splitlines(),
                       "launches": served}
        for k in launches:
            launches[k] += served[k]
    # Two bf16 draws in each of the two random runs.
    prng_launches = prng.launches - prng_before
    check(prng_launches == 4, f"matrix_test: {prng_launches} draw launches in two random runs")

    # matrix_test's random inputs: JAX's normal(PRNGKey(0)) for both.
    a = b = prng.normal(0, (n, n), DEVICE, torch.bfloat16)
    check(gemm_kernel(a, b) == "sm90", f"gemm {n}^3 would not take the sm90 kernel")
    random_case, want = gemm_case(torch, mm, f"gemm {n}^3 random", a, b, kw)
    lib = torch.mm(a, b, out_dtype=torch.float32)
    random_case["torch_mm_vs_plain_rel_err"] = float((lib - want).abs().max()) / float(
        want.abs().max())
    del want, lib
    ones = torch.ones((n, n), dtype=torch.bfloat16, device=DEVICE)
    before = gemm_counts(mm)
    ones_exact = bool(torch.equal(mm(ones, ones, **kw), torch.full((n, n), float(n),
                                                                      device=DEVICE)))
    served_ones = {k: v - before[k] for k, v in gemm_counts(mm).items()}
    del ones
    out(random_case)
    out({"case": f"gemm {n}^3 ones", "kernel": [k for k, v in served_ones.items() if v],
         "all_entries_equal_n": ones_exact})
    check_gemm_case(random_case, "sm90")
    check(served_ones == {"sm90": 1, "packed": 0}, f"gemm {n}^3 ones: launches {served_ones}")
    check(ones_exact, f"gemm {n}^3 ones: an entry differs from {n}")

    max_err = {"sm90": random_case["max_abs_err"], "packed": 0.0}
    odd_small = {}
    for m_, k_, n_, blk, kernel in GEMM_EDGE_SHAPES:
        g = torch.Generator(device=DEVICE).manual_seed(m_)
        ea = torch.randn((m_, k_), generator=g, device=DEVICE).to(torch.bfloat16)
        eb = torch.randn((k_, n_), generator=g, device=DEVICE).to(torch.bfloat16)
        ekw = dict(bm=blk, bn=blk, bk=blk)
        case, _ = gemm_case(torch, mm, f"gemm ({m_}, {k_}) x ({k_}, {n_}), blocks {blk}",
                            ea, eb, ekw)
        out(case)
        check_gemm_case(case, kernel)
        max_err[kernel] = max(max_err[kernel], case["max_abs_err"])
        if m_ * k_ * n_ < 10**5:
            odd_small = {"shape": f"({m_}, {k_}) x ({k_}, {n_})",
                         "ms": cuda_ms(torch, lambda: mm(ea, eb, **ekw), 20)}
    m_, k_, n_, blk = GEMM_MISALIGNED
    g = torch.Generator(device=DEVICE).manual_seed(m_ + 1)
    # A starts one bf16 element into its storage: contiguous, 2 bytes off.
    ea = torch.randn((m_ * k_ + 1,), generator=g, device=DEVICE).to(torch.bfloat16)[1:]
    ea = ea.view(m_, k_)
    eb = torch.randn((k_, n_), generator=g, device=DEVICE).to(torch.bfloat16)
    check(ea.is_contiguous() and ea.data_ptr() % 16 != 0, "the misaligned case is aligned")
    case, _ = gemm_case(torch, mm, f"gemm ({m_}, {k_}) x ({k_}, {n_}), A 2 bytes off 16-byte "
                        f"alignment, blocks {blk}", ea, eb, dict(bm=blk, bn=blk, bk=blk))
    out(case)
    check_gemm_case(case, "packed")
    max_err["packed"] = max(max_err["packed"], case["max_abs_err"])

    reps = 10
    ms = cuda_ms(torch, lambda: mm(a, b, **kw), reps)
    plain_ms = cuda_ms(torch, lambda: matmul_blocked_plain(a, b, **kw), 3)
    library_ms = cuda_ms(torch, lambda: torch.mm(a, b, out_dtype=torch.float32), reps)
    bound_ms, bound_by = gemm_bound_ms(n, n, n)
    flops = 2.0 * n ** 3
    del a, b

    # The packed route at matrix_test's odd shape: two launches bit-equal,
    # then its ms and torch.mm's in turns, both calls' device ms, a burst
    # of back-to-back calls and the host's enqueue µs a call (one call at
    # a time is the host's pace, not the card's).
    no = GEMM_ODD_N
    oa = ob = prng.normal(0, (no, no), DEVICE, torch.bfloat16)
    case, _ = gemm_case(torch, mm, f"gemm {no}^3 random, blocks {GEMM_ODD_BLOCK}", oa, ob, okw)
    out(case)
    check_gemm_case(case, "packed")
    max_err["packed"] = max(max_err["packed"], case["max_abs_err"])
    first, again = mm(oa, ob, **okw), mm(oa, ob, **okw)
    repeat = same_bits(torch, first, again)
    del first, again
    check(repeat, f"gemm {no}^3: two launches of the packed route differ")
    packed_call = lambda: mm(oa, ob, **okw)  # noqa: E731
    mm_call = lambda: torch.mm(oa, ob, out_dtype=torch.float32)  # noqa: E731
    packed_ms, packed_lib_ms = cuda_ms_turns(torch, [packed_call, mm_call], 20)
    packed_bound_ms, packed_bound_by = gemm_bound_ms(no, no, no)
    packed = {"shape": f"({no}, {no}) x ({no}, {no}) bf16 -> f32, blocks {GEMM_ODD_BLOCK}",
              "ms": packed_ms, "library_ms": packed_lib_ms,
              "no_slower_than_torch_mm": packed_ms <= packed_lib_ms,
              "timed": "CUDA events, median of 20, in turns with torch.mm",
              "burst_ms": cuda_ms(torch, lambda: [packed_call() for _ in range(20)], 3) / 20,
              "library_burst_ms": cuda_ms(torch, lambda: [mm_call() for _ in range(20)], 3) / 20,
              "device_ms": pass_ms(torch, packed_call, reps=20),
              "library_device_ms": pass_ms(torch, mm_call, reps=20),
              "enqueue_us": enqueue_us(torch, packed_call, 200),
              "library_enqueue_us": enqueue_us(torch, mm_call, 200),
              "two_launches_bit_equal": repeat,
              "plain_ms": cuda_ms(torch, lambda: matmul_blocked_plain(oa, ob, **okw), 3),
              "bound_ms": packed_bound_ms, "bound_by": packed_bound_by, "odd_small": odd_small}
    del oa, ob

    res = {"gemm_times": {
        "shape": f"({n}, {n}) x ({n}, {n}) bf16 -> f32",
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "tflops": flops / ms / 1e9, "library_tflops": flops / library_ms / 1e9,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "matrix_test": {k: v["times"] for k, v in runs.items()},
        "launches": launches, "prng_launches": prng_launches, "packed": packed,
        "card": card}}
    out(res)
    res = res["gemm_times"]
    res["max_abs_err"] = max_err
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
    run: one call at the default run, launches counted; then the kernels
    bit-equal to their plain version on all 9 rows for random and
    tie-heavy keys at every tested run; kernel, plain and library times
    and the kernels one call launches."""
    from gaussianrenderer_tpu_torch.ops.cuda.block_sort import block_sort_runs_plain

    bs = gt.block_sort_runs
    x = sort_matrix(torch, c, 2**32, seed=0)
    bs.launches = bs.kernel_launches = 0
    y = bs(x)
    torch.cuda.synchronize()
    launches, kernel_launches = bs.launches, bs.kernel_launches
    check(launches == 1 and kernel_launches == 1,
          f"block sort: {launches} calls, {kernel_launches} kernels for one call")
    keys = y[0].view(c // 2048, 2048)
    check(bool((keys[:, 1:] >= keys[:, :-1]).all()), "block sort: a run is not sorted")
    check(int(x[0].max()) >= 2**31, "block sort: no key with the top bit set")

    def library(xi, run):
        kv, perm = torch.sort(xi[0].view(-1, run), dim=1)
        pay = torch.gather(xi[1:].view(8, -1, run), 2, perm.expand(8, -1, -1))
        return kv, pay

    times = {}
    for run in BLOCK_SORT_RUNS:
        c_run = -(-c // run) * run
        xr = x if c_run == c else sort_matrix(torch, c_run, 2**32, seed=run + 1)
        for kind, key_hi in (("random u32", 2**32), ("tie-heavy, keys in [0, 16)", 16)):
            xi = xr if key_hi == 2**32 else sort_matrix(torch, c_run, key_hi, run)
            got, want = bs(xi, run=run), block_sort_runs_plain(xi, run=run)
            differ = int((got != want).sum())
            out({"case": f"block sort run {run}, {kind}", "c": c_run,
                 "elements_differing": differ,
                 "max_abs": float((got - want).abs().max())})
            check(differ == 0, f"block sort run {run} {kind}: {differ} elements differ")
            del got, want
        before = bs.kernel_launches
        bs(xr, run=run)
        per_call = bs.kernel_launches - before
        bound_ms, bound_by, substages = block_sort_bound_ms(c_run, run)
        times[run] = {
            "c": c_run,
            "ms": cuda_ms(torch, lambda: bs(xr, run=run), 10),
            "plain_ms": cuda_ms(torch, lambda: block_sort_runs_plain(xr, run=run), 2),
            "library_ms": cuda_ms(torch, lambda: library(xr, run), 10),
            "bound_ms": bound_ms, "bound_by": bound_by, "substages": substages,
            "kernel_launches_per_call": per_call,
        }
        del xr
        torch.cuda.empty_cache()
    res = {"block_sort_times": {
        "c": c, "shape": f"(9, {c}) u32 as int64, random keys",
        "library_call": "torch.sort along dim 1 of the (C/run, run) key view + "
                        "one torch.gather of the 8 payload rows",
        "runs": times, "launches": launches, "kernel_launches": kernel_launches,
        "card": card}}
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


# ------------------------------------------------------------ multi-device
def mc_modules():
    import torch
    import torch.distributed as dist

    import gaussianrenderer_tpu_torch as gt
    from gaussianrenderer_tpu_torch import parallel as par
    from gaussianrenderer_tpu_torch.parallel import multichip as mc

    return torch, dist, gt, par, mc


def mc_synced_ms(torch, dist, mesh, fn, reps):
    """Per-call ms of ``fn`` on this rank, every call started together on
    all ranks (a barrier) and ended by a card synchronize; all values."""
    times = []
    for _ in range(reps):
        dist.barrier(group=mesh.group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def mc_exchange_ms(torch, dist, mc, mesh, shard, camp, cfg, exchange, kw, reps):
    """The record exchange alone, on this rank's projection of its shard:
    synchronized ms of each call, and the bytes it sent and received."""
    from gaussianrenderer_tpu_torch.ops.compositing import build_features
    from gaussianrenderer_tpu_torch.ops.instances import encode_record_rows, u32_to_i32

    proj = mc._probe(shard, camp, cfg)
    if exchange == "gather32":
        rec = torch.cat([build_features(proj), proj.tile_min.float(), proj.tile_max.float(),
                         proj.depth[:, None], proj.valid.float()[:, None]], dim=-1)
        fn = lambda: mc._all_gather(mesh, rec, 0)  # noqa: E731
        sent = rec.numel() * 4
    else:
        rows = encode_record_rows(proj)
        if exchange == "gather_q":
            wire = u32_to_i32(rows).T.contiguous()
            fn = lambda: mc._all_gather(mesh, wire, 0)  # noqa: E731
            sent = wire.numel() * 4
        else:
            rects = kw.get("strip_rects")
            bounds = None if rects is not None else kw.get("strip_bounds") or tuple(
                i * (cfg.tiles_y // mesh.size) for i in range(mesh.size + 1))
            fn = lambda: mc._exchange_a2a(  # noqa: E731
                mesh, rows, proj.tile_min[:, 1], proj.tile_max[:, 1], proj.valid,
                bounds=bounds, strip_rects=rects, tmin_x=proj.tile_min[:, 0],
                tmax_x=proj.tile_max[:, 0])
            sent = None
    ms = mc_synced_ms(torch, dist, mesh, fn, reps)
    if sent is None:
        sent = mc.last_frame["records_sent"]
    return {"ms_median": statistics.median(ms), "ms_all": ms, "bytes_sent": sent}


def mc_frames_rank(mesh, cases, with_xla, frames):
    """One rank of multichip-3m: bench_3m's single-device frame on this
    rank, then each case of ``cases`` ((label, render_frame_multichip
    kwargs)) through the multi-device main path. The compositor's count
    is set to 0 just before a case's first frame and read after its timed
    frames. With ``with_xla`` also the gather32 frame on the xla
    compositor against the single-device xla frame."""
    torch, dist, gt, par, mc = mc_modules()
    scene, cam, cfg = bench_3m_setup(device=mesh.device)
    camp = cam.params(cfg.k_sigma, device=mesh.device)
    ref, ref_stats = gt.render_frame(scene, camp, cfg)
    single_instances = int(ref_stats.num_instances)
    shard = par.shard_scene(scene, mesh)
    comp = gt.composite_tiles_packed
    res = {"rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device),
           "single_instances": single_instances, "shard_splats": shard.num_gaussians,
           "shape": list(ref.shape)}
    for label, kw in cases:
        comp.launches = gt.table_lookup.launches = 0
        fb, stats = par.render_frame_multichip(shard, camp, cfg, mesh, **kw)
        torch.cuda.synchronize()
        instances = int(mc.last_frame["instances"])
        frame = {k: v for k, v in mc.last_frame.items() if k != "instances"}
        ms = mc_synced_ms(torch, dist, mesh, lambda: par.render_frame_multichip(
            shard, camp, cfg, mesh, **kw), frames)
        launches = comp.launches
        res[label] = {
            "max_abs_err": float((fb - ref).abs().max()),
            "finite": bool(torch.isfinite(fb).all()),
            "shape": list(fb.shape),
            "overflow": bool(stats["overflow"]),
            "center_clipped": bool(stats["center_clipped"]),
            "instances": instances,
            "frame_ms_median": statistics.median(ms),
            "frame_ms_all": ms,
            "launches": launches,
            "lookup_launches": gt.table_lookup.launches,
            "bytes": frame,
            "exchange": mc_exchange_ms(torch, dist, mc, mesh, shard, camp, cfg,
                                       kw.get("exchange", "gather_q"), kw, frames),
        }
    if with_xla:
        xcfg = dataclasses.replace(cfg, compositor="xla")
        refx = gt.render_frame(scene, camp, xcfg)[0]
        fbx, _ = par.render_frame_multichip(shard, camp, xcfg, mesh, exchange="gather32")
        res["gather32_xla"] = {"max_abs_err": float((fbx - refx).abs().max()),
                               "instances": int(mc.last_frame["instances"])}
    return res


def mc_check_frames(label, results, cases, atol):
    for r in results:
        for case, _ in cases:
            c = r[case]
            name = f"{label} rank {r['rank']} {case}"
            check(c["finite"] and c["shape"] == r["shape"], f"{name}: frame {c['shape']}")
            check(not c["overflow"], f"{name}: overflow")
            check(c["max_abs_err"] <= atol, f"{name}: {c['max_abs_err']} from render_frame")
            check(c["launches"] == MC_FRAMES + 1,
                  f"{name}: {c['launches']} compositor launches in {MC_FRAMES + 1} frames")
            check(c["lookup_launches"] == 0, f"{name}: lookups on the unculled path")
    for case, _ in cases:
        # Strips partition the tiles: their instances add up exactly.
        total = sum(r[case]["instances"] for r in results)
        check(total == results[0]["single_instances"],
              f"{label} {case}: strips emit {total}, the single device "
              f"{results[0]['single_instances']}")


def phase_multichip_3m(torch, gt, big, card):
    """multichip-3m: bench_3m through render_frame_multichip with D ranks
    sharing the card over gloo: D = 2 on equal strips with each exchange
    (and gather32 on the xla compositor), D = 4 on balanced strips and on
    balanced rects under a2a_q, then a one-rank NCCL group; frames
    against render_frame on each rank."""
    from gaussianrenderer_tpu_torch import parallel as par

    scene, cam, cfg = big
    camp = cam.params(cfg.k_sigma, device=DEVICE)
    bounds = par.balance_strips_for_scene(scene, camp, cfg, MC_D_BALANCED)
    rects, slack = par.balance_rects_for_scene(scene, camp, cfg, MC_D_BALANCED)
    eq_cases = [(ex, {"exchange": ex}) for ex in MC_EXCHANGES]
    bal_cases = [("balanced_gather_q", {"exchange": "gather_q", "strip_bounds": bounds}),
                 ("balanced_a2a_q", {"exchange": "a2a_q", "strip_bounds": bounds}),
                 ("rects_a2a_q", {"exchange": "a2a_q", "strip_rects": rects})]
    res = {"card": card, "shared_card": True, "bounds": bounds, "rects": rects,
           "rect_slack": slack}
    t0 = time.perf_counter()
    d2 = par.spawn(mc_frames_rank, MC_D_SMALL, eq_cases, True, MC_FRAMES, backend="gloo",
                   device=DEVICE, timeout=MC_SPAWN_TIMEOUT)
    res["d2_seconds"] = time.perf_counter() - t0
    out({"multichip_3m": "D=2 gloo, one card", "card": card, "ranks": d2})
    mc_check_frames("D=2", d2, eq_cases, MC_ATOL_PACKED)
    for r in d2:
        check(r["gather32_xla"]["max_abs_err"] <= MC_ATOL_F32,
              f"D=2 rank {r['rank']} gather32 xla: {r['gather32_xla']['max_abs_err']}")
    t0 = time.perf_counter()
    d4 = par.spawn(mc_frames_rank, MC_D_BALANCED, bal_cases, False, MC_FRAMES,
                   backend="gloo", device=DEVICE, timeout=MC_SPAWN_TIMEOUT)
    res["d4_seconds"] = time.perf_counter() - t0
    out({"multichip_3m": "D=4 gloo, one card", "card": card, "bounds": bounds,
         "rects": rects, "rect_slack": slack, "ranks": d4})
    mc_check_frames("D=4", d4, bal_cases, MC_ATOL_PACKED)
    t0 = time.perf_counter()
    d1 = par.spawn(mc_frames_rank, 1, eq_cases, False, MC_NCCL_FRAMES, backend="nccl",
                   device=DEVICE,
                   timeout=MC_SPAWN_TIMEOUT)
    res["nccl_seconds"] = time.perf_counter() - t0
    out({"multichip_3m": "D=1 nccl", "card": card, "ranks": d1})
    for case, _ in eq_cases:
        c = d1[0][case]
        check(d1[0]["backend"] == "nccl" and c["max_abs_err"] == 0.0,
              f"one-rank NCCL {case}: {c['max_abs_err']} from render_frame")
        check(c["instances"] == d1[0]["single_instances"], f"one-rank NCCL {case}: instances")
        check(c["launches"] == MC_NCCL_FRAMES + 1,
              f"one-rank NCCL {case}: {c['launches']} launches in {MC_NCCL_FRAMES + 1} frames")
    launches = {"d2": {c: [r[c]["launches"] for r in d2] for c, _ in eq_cases},
                "d4": {c: [r[c]["launches"] for r in d4] for c, _ in bal_cases},
                "nccl": {c: d1[0][c]["launches"] for c, _ in eq_cases}}
    res.update({"d2": d2, "d4": d4, "nccl": d1, "launches": launches,
                "kernel_launches": sum(v for g in ("d2", "d4") for c in launches[g].values()
                                       for v in c) + sum(launches["nccl"].values())})
    return res


class GradKeeper:
    """An optimizer that keeps the first gradients it is given and hands
    every step on to ``inner``."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params=None):
        if self.grads is None:
            self.grads = grads
        return self.inner.update(grads, state, params)


def mc_train_rank(mesh, bounds, ckpt_dir):
    """One rank of multichip-train-500k: the single-device first step's
    gradients (MSE, the 3DGS Adam), then MC_TRAIN_STEPS mesh steps from
    the same start with the train kernels' counts set to 0 just before
    and read just after, then fit_scene(mesh) for MC_FIT_STEPS with a
    checkpoint every MC_FIT_CHECKPOINT steps and a resume from the first."""
    import hashlib

    torch, dist, gt, par, mc = mc_modules()
    from gaussianrenderer_tpu_torch import train as ptrain
    from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt

    scene = trained_500k_setup(device=mesh.device)[0]
    cfg = train_500k_config(gt)
    cams = train_poses(gt, cfg)
    truth = gt.SceneParams.from_scene(scene)
    with torch.no_grad():
        targets = [gt.render_for_training(truth, c, cfg) for c in cams]
    params0 = perturbed(torch, gt, truth)
    n = params0.positions.shape[0]
    keep1 = GradKeeper(gt.make_3dgs_optimizer())
    step1, _ = gt.make_train_step(cfg, optimizer=keep1, loss_fn=gt.mse_loss)
    _, _, loss1 = step1(params0, keep1.init(params0), cams[0], targets[0])

    keep = GradKeeper(gt.make_3dgs_optimizer())
    step, _ = gt.make_multichip_train_step(cfg, mesh, keep, strip_bounds=bounds)
    params = ptrain._mesh_shard(gt.pad_params_for_mesh(params0, mesh.size), mesh)
    state = keep.init(params)
    padded = [gt.pad_target_for_mesh(t, cfg) for t in targets]
    ns = params.positions.shape[0]
    lo, hi = mesh.rank * ns, min((mesh.rank + 1) * ns, n)
    losses, step_ms = [], []
    tt.train_forward.launches = tt.train_backward.launches = 0
    gt.composite_tiles_packed.launches = 0
    for s in range(MC_TRAIN_STEPS):
        i = s % TRAIN_POSES
        dist.barrier(group=mesh.group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, cams[i], padded[i])
        losses.append(float(loss))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = {"tile_train_fwd": tt.train_forward.launches,
                "tile_train_bwd": tt.train_backward.launches,
                "tile_render2": gt.composite_tiles_packed.launches}
    instances = int(mc.last_frame["instances"])
    grad_rel = {}
    for name, g1, gm in zip(gt.SceneParams._fields, keep1.grads, keep.grads):
        if g1 is None:
            continue
        scale = float(torch.nan_to_num(g1).abs().max())
        d = torch.nan_to_num(gm[: hi - lo] - g1[lo:hi]).abs().max()
        grad_rel[name] = float(d) / max(scale, 1e-30)
    finite = all(bool(torch.isfinite(p[: hi - lo])[torch.isfinite(p0[lo:hi])].all())
                 for p, p0 in zip(params, params0) if p is not None)

    views = list(zip(cams, targets))
    tt.train_forward.launches = tt.train_backward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, hist = gt.fit_scene(views, cfg, params0, steps=MC_FIT_STEPS, mesh=mesh,
                                strip_bounds=bounds, checkpoint_dir=ckpt_dir,
                                checkpoint_every=MC_FIT_CHECKPOINT, log_every=5)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0) / MC_FIT_STEPS
    fit_launches = {"tile_train_fwd": tt.train_forward.launches,
                    "tile_train_bwd": tt.train_backward.launches}
    first = os.path.join(ckpt_dir, f"step_{MC_FIT_CHECKPOINT:06d}")
    refitted, resumed = gt.fit_scene(views, cfg, params0, steps=MC_FIT_STEPS, mesh=mesh,
                                     strip_bounds=bounds, resume_from=first, log_every=5)

    def sha(tree):
        return {k: hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
                for k, v in tree._asdict().items() if v is not None}

    digest = sha(fitted)
    return {"rank": mesh.rank, "backend": mesh.backend, "shard_rows": [lo, hi],
            "single_loss": float(loss1), "losses": losses, "step_ms_median":
            statistics.median(step_ms), "step_ms_all": step_ms, "launches": launches,
            "instances_last_step": instances, "grad_max_rel": grad_rel,
            "finite_params_stay_finite": finite, "fit_losses": hist["losses"],
            "fit_ms_per_step": fit_ms, "fit_launches": fit_launches,
            "resumed_losses": resumed["losses"], "fitted_sha256": digest,
            "resumed_sha256": sha(refitted),
            "fitted_splats": int(fitted.positions.shape[0])}


def phase_multichip_train(torch, gt, scene, card):
    """multichip-train-500k: make_multichip_train_step and
    fit_scene(mesh) on data/trained_500k.ply at its fitting config
    (640×480, 15 tile rows: balanced strips) with MC_D_SMALL ranks
    sharing the card over gloo."""
    from gaussianrenderer_tpu_torch import parallel as par

    cfg = train_500k_config(gt)
    cams = train_poses(gt, cfg)
    bounds = par.balance_strips_for_scene(scene, cams[0], cfg, MC_D_SMALL)
    ckpt = fit_dir("multichip_fit")
    t0 = time.perf_counter()
    ranks = par.spawn(mc_train_rank, MC_D_SMALL, bounds, ckpt, backend="gloo", device=DEVICE,
                      timeout=MC_SPAWN_TIMEOUT)
    seconds = time.perf_counter() - t0
    out({"multichip_train_500k": f"D={MC_D_SMALL} gloo, one card", "card": card,
         "bounds": bounds, "seconds": seconds, "ranks": ranks})
    for r in ranks:
        name = f"multichip-train rank {r['rank']}"
        losses = r["losses"]
        check(all(math.isfinite(v) for v in losses), f"{name}: loss {losses}")
        check(losses == ranks[0]["losses"], f"{name}: losses differ between ranks")
        check(abs(losses[0] - r["single_loss"]) <= MC_GRAD_REL * r["single_loss"],
              f"{name}: first loss {losses[0]} vs single device {r['single_loss']}")
        first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
        check(last < first, f"{name}: loss did not fall ({first:.5g} → {last:.5g})")
        check(all(v <= MC_GRAD_REL for v in r["grad_max_rel"].values()),
              f"{name}: gradients {r['grad_max_rel']} from the single device's")
        check(r["launches"]["tile_train_fwd"] == MC_TRAIN_STEPS
              and r["launches"]["tile_train_bwd"] == MC_TRAIN_STEPS,
              f"{name}: train kernel calls {r['launches']} in {MC_TRAIN_STEPS} steps")
        check(r["finite_params_stay_finite"], f"{name}: a finite parameter became non-finite")
        fit = r["fit_losses"]
        check(len(fit) == MC_FIT_STEPS and all(math.isfinite(v) for v in fit),
              f"{name}: fit losses {fit}")
        check(statistics.mean(fit[-3:]) < statistics.mean(fit[:3]), f"{name}: fit did not fall")
        check(r["fit_launches"]["tile_train_fwd"] == MC_FIT_STEPS
              and r["fit_launches"]["tile_train_bwd"] == MC_FIT_STEPS,
              f"{name}: fit kernel calls {r['fit_launches']}")
        res_l = r["resumed_losses"]
        ref_l = fit[MC_FIT_CHECKPOINT:]
        check(res_l == ref_l, f"{name}: resumed losses {res_l} vs {ref_l}")
        check(r["resumed_sha256"] == r["fitted_sha256"],
              f"{name}: the resumed fit's params differ from the fit's")
        check(r["fitted_splats"] == scene.num_gaussians, f"{name}: fitted N")
        check(r["fitted_sha256"] == ranks[0]["fitted_sha256"], f"{name}: fitted params differ")
    # Rank 0's last checkpoint is the whole un-padded state a single-device
    # load_checkpoint reads, bit for bit the params every rank returned.
    import hashlib

    template = gt.SceneParams.from_scene(scene)
    loaded, _, _, at = gt.load_checkpoint(os.path.join(ckpt, f"step_{MC_FIT_STEPS:06d}"),
                                          template)
    digest = {k: hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
              for k, v in loaded._asdict().items() if v is not None}
    check(at == MC_FIT_STEPS and digest == ranks[0]["fitted_sha256"],
          "multichip-train: the mesh checkpoint does not hold the fitted params")
    launches = {k: sum(r["launches"][k] + r["fit_launches"].get(k, 0) for r in ranks)
                for k in ("tile_train_fwd", "tile_train_bwd")}
    return {"ranks": ranks, "bounds": bounds, "seconds": seconds, "launches": launches}


def params_digest(params):
    """sha256 of every parameter's bytes, in field order: equal digests
    are equal bits."""
    h = hashlib.sha256()
    for p in params:
        if p is not None:
            h.update(p.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def train_times(root) -> int:
    """``--train-times ROOT``: the training path's times and bits with the
    port package of the checkout at ROOT (this checkout's data and
    harness): TRAIN_STEPS synchronized train-500k steps (host clock), a
    FIT_STEPS fit-500k fit without checkpoints (wall ms a step, one
    synchronize at its end), the same fit with a checkpoint every
    FIT_CHECKPOINT_EVERY steps and a resume from the first, one densify
    episode after FIT_TIMED_STEPS densifying steps (CUDA events, median
    of 5, as fit-500k times it), the backward train kernel on the first
    step's inputs (CUDA events) with each of its passes' device ms
    (torch.profiler), and the training gather's transpose (its autograd
    backward on a seeded cotangent: CUDA events and device ms by
    kernel), and the tile assignment without gradients
    (``build_sorted_instances`` on the first step's projection: CUDA
    events, and its kernels' device ms summed). The steps', the fits' and
    the resume's losses and final
    params' digests go with the times. Prints one ``{"train_times": ...}``
    line."""
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
        return 1
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import gaussianrenderer_tpu_torch as gt
    from gaussianrenderer_tpu_torch import train as ptrain
    from gaussianrenderer_tpu_torch.ops.compositing import gather_sorted_features_seg
    from gaussianrenderer_tpu_torch.ops.cuda import tile_train as tt

    check(os.path.dirname(os.path.dirname(os.path.abspath(gt.__file__))) == root,
          f"imported {gt.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    scene = trained_500k_setup()[0]
    cfg = train_500k_config(gt)
    cams = train_poses(gt, cfg)
    truth = gt.SceneParams.from_scene(scene)
    with torch.no_grad():
        targets = [gt.render_for_training(truth, c, cfg) for c in cams]
    params0 = perturbed(torch, gt, truth)
    opt = gt.make_3dgs_optimizer()
    step, _ = gt.make_train_step(cfg, optimizer=opt, loss_fn=gt.l1_dssim_loss)
    step(params0, opt.init(params0), cams[0], targets[0])  # builds, warms up
    params, state = params0, opt.init(params0)
    losses, step_ms = [], []
    for s in range(TRAIN_STEPS):
        i = s % TRAIN_POSES
        (params, state, loss), ms = host_ms(
            torch, lambda: step(params, state, cams[i], targets[i]))
        losses.append(float(loss))
        step_ms.append(ms)
    step_params = params_digest(params)
    del params, state
    views = list(zip(cams, targets))
    fit_kw = dict(steps=FIT_STEPS, loss_fn=gt.l1_dssim_loss, densify_every=FIT_DENSIFY_EVERY,
                  densify_stop=0.7)

    def optimizer():
        return gt.make_3dgs_optimizer(position_lr_max_steps=FIT_STEPS)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, hist = gt.fit_scene(views, cfg, params0, optimizer=optimizer(), **fit_kw)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3 / FIT_STEPS
    fit_params = params_digest(fitted)
    del fitted
    # The fit again with checkpoints, and a resume from the first.
    ck = fit_dir(f"chip_smoke_turns_{os.getpid()}")
    again, hist_a = gt.fit_scene(views, cfg, params0, optimizer=optimizer(), checkpoint_dir=ck,
                                 checkpoint_every=FIT_CHECKPOINT_EVERY, **fit_kw)
    repeat_params = params_digest(again)
    del again
    resumed, hist_r = gt.fit_scene(
        views, cfg, params0, optimizer=optimizer(),
        resume_from=os.path.join(ck, f"step_{FIT_CHECKPOINT_EVERY:06d}"), **fit_kw)
    resume_params = params_digest(resumed)
    del resumed
    shutil.rmtree(ck)
    # One densify episode from FIT_TIMED_STEPS densifying steps, as fit-500k times it.
    dopt = gt.make_3dgs_optimizer()
    dstep = ptrain._make_step_fn(cfg, dopt, gt.l1_dssim_loss, timed=False, densify=True)
    dp, dst = params0, dopt.init(params0)
    ds = gt.DensifyState.zero(params0.positions.shape[0], device=DEVICE)
    for s in range(FIT_TIMED_STEPS):
        dp, dst, ds, _, _ = dstep(dp, dst, ds, *views[s % len(views)])
    prune = episode_prune_scale(cams)
    episode_ms = cuda_ms(torch, lambda: gt.densify_step(dp, dst, ds, seed=1, prune_scale=prune), 5)
    del dp, dst, ds
    with torch.no_grad():
        sf, asg = train_inputs(gt, params0, cams[0], cfg)
    kw = train_kw(cfg)
    off, n_chk = tt.chunk_offsets(asg.tile_start, asg.tile_count, cfg.chunk_size)
    args = (sf, asg.tile_start, asg.tile_count, off)
    stats, chk = tt.train_forward(*args, n_chk, **kw)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    gout = torch.randn(stats.shape, generator=gen, device=DEVICE)
    gout[4:] = 0.0
    bwd = lambda: tt.train_backward(*args, gout, stats, chk, **kw)  # noqa: E731
    # The gather's transpose: its backward alone, the graph kept.
    with torch.no_grad():
        proj = gt.preprocess_gaussians(
            params0.to_scene(), cams[0], width=cfg.width, height=cfg.height,
            tile_w=cfg.tile_w, tile_h=cfg.tile_h, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
            sh_degree=cfg.sh_degree, quantize_centers=False)
    tiling = lambda: gt.build_sorted_instances(  # noqa: E731
        proj, tiles_x=cfg.tiles_x, num_tiles=cfg.num_tiles, near=cams[0].near, far=cams[0].far)
    leaf = gt.build_features(proj).detach().requires_grad_(True)
    gathered = gather_sorted_features_seg(leaf, asg, cfg.chunk_size)
    cot = torch.randn(gathered.shape, generator=gen, device=DEVICE)
    transpose = lambda: torch.autograd.grad(gathered, leaf, cot, retain_graph=True)  # noqa: E731
    out({"train_times": {
        "package": root, "card": card_line(),
        "step_ms_median": statistics.median(step_ms), "step_ms_all": step_ms,
        "losses": losses, "step_params": step_params,
        "fit_ms_per_step": fit_ms, "fit_losses": hist["losses"], "fit_params": fit_params,
        "repeat_losses": hist_a["losses"], "repeat_params": repeat_params,
        "resume_losses": hist_r["losses"], "resume_params": resume_params,
        "episode_ms_median_of_5": episode_ms,
        "fit_episodes": hist["densify"], "bwd_ms": cuda_ms(torch, bwd, 10),
        "bwd_pass_device_ms": pass_ms(torch, bwd, reps=10),
        "transpose_ms": cuda_ms(torch, transpose, 10),
        "transpose_device_ms": pass_ms(torch, transpose, reps=10),
        "tiling_ms": cuda_ms(torch, tiling, 20),
        "tiling_device_ms": sum(pass_ms(torch, tiling, reps=10).values()),
        "instances": int(asg.total_instances), "checkpoint_rows": n_chk,
    }})
    return 0


def train_turns(parent, same_bits=False) -> int:
    """``--train-turns PARENT``: :func:`train_times` of the checkout at
    PARENT (say, the parent commit's ``git archive``) and of this one, in
    turns (parent, change, change, parent), each in a process of its own
    on the one card. Prints each run's line, then one ``{"train_turns":
    ...}`` line with both versions' numbers side by side, and whether
    every run gave the same bits: the steps' losses and params, the fit's
    losses, episodes and params, its repeat and its resume. Fails unless
    every run repeats and resumes its own fit and, with ``same_bits``
    (``--same-bits``: for a change that means to keep every bit), unless
    all four runs give the same bits."""
    runs = []
    for label, root in (("parent", parent), ("change", REPO), ("change", REPO),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--train-times",
                               root], capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"train_times"')]
        if proc.returncode != 0 or not lines:
            log(proc.stderr[-4000:])
            raise RuntimeError(f"--train-times {root} exited {proc.returncode}")
        out(lines[-1])
        runs.append({"label": label, **json.loads(lines[-1])["train_times"]})

    def side(key):
        return {lab: [r[key] for r in runs if r["label"] == lab] for lab in ("parent", "change")}

    def grads_pass(r):
        return r["bwd_pass_device_ms"].get("bwd_grads_kernel")

    bit_keys = ("losses", "step_params", "fit_losses", "fit_episodes", "fit_params",
                "repeat_params", "resume_losses", "resume_params")
    own = {f"{r['label']} {i}": (r["repeat_losses"] == r["fit_losses"]
                                 and r["repeat_params"] == r["fit_params"]
                                 and r["resume_losses"] == r["fit_losses"][FIT_CHECKPOINT_EVERY:]
                                 and r["resume_params"] == r["fit_params"])
           for i, r in enumerate(runs)}
    across = {key: all(r[key] == runs[0][key] for r in runs) for key in bit_keys}
    out({"train_turns": {
        "order": [r["label"] for r in runs], "card": card_line(),
        "step_ms_median": side("step_ms_median"), "fit_ms_per_step": side("fit_ms_per_step"),
        "episode_ms_median_of_5": side("episode_ms_median_of_5"),
        "bwd_ms": side("bwd_ms"),
        "bwd_grads_pass_device_ms": {lab: [grads_pass(r) for r in runs if r["label"] == lab]
                                     for lab in ("parent", "change")},
        "transpose_ms": side("transpose_ms"),
        "transpose_device_ms": side("transpose_device_ms"),
        "tiling_ms": side("tiling_ms"), "tiling_device_ms": side("tiling_device_ms"),
        "fit_losses": side("fit_losses"),
        "runs_repeat_losses": {
            lab: all(r["losses"] == same[0]["losses"] and r["fit_losses"] == same[0]["fit_losses"]
                     for r in same)
            for lab, same in ((lab, [r for r in runs if r["label"] == lab])
                              for lab in ("parent", "change"))},
        "each_run_repeats_and_resumes_its_fit": own,
        "bits_equal_across_all_runs": across,
        "bits_gated": same_bits,
    }})
    check(all(own.values()), f"train turns: a run's fit does not repeat or resume: {own}")
    if same_bits:
        check(all(across.values()), f"train turns: the runs' bits differ: {across}")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
        return 1
    sys.path.insert(0, REPO)
    import gaussianrenderer_tpu_torch as gt
    from gaussianrenderer_tpu_torch import _build
    from gaussianrenderer_tpu_torch.native import colmap_native, ply_native
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
        # The host C++ readers (g++), before any phase loads a PLY.
        t0 = time.perf_counter()
        ply_native.library()
        colmap_native.library()
        out({"native_build_seconds": time.perf_counter() - t0,
             "cxx": _build.find_cxx(),
             "native_libraries": [os.path.relpath(_build.NATIVE.library_path(n), REPO)
                                  for n in ("ply_loader", "colmap_loader")]})
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
    del big_inst, inst3m
    torch.cuda.empty_cache()

    with Phase("multichip-3m", torch):
        mc3m = phase_multichip_3m(torch, gt, big, card)

    with Phase("native-io", torch):
        native_res = phase_native_io(torch, gt, big, card)
    del big
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
        train_times = phase_train_kernel_vs_plain(torch, gt,
                                                  (sf, asg, tcfg, scene500.num_gaussians))
        del sf, asg, truth

    with Phase("train-500k", torch):
        train_res = phase_train(torch, gt, scene500, card)

    with Phase("fit-500k", torch):
        fit_res, first_episode = phase_fit(torch, gt, scene500, card)

    with Phase("densify-draw", torch):
        draw_res = phase_densify_draw(torch, gt, scene500.num_gaussians, first_episode, card)
    del first_episode
    torch.cuda.empty_cache()

    with Phase("fit-app", torch):
        fit_app_res = phase_fit_app(torch, gt, scene500, card)

    with Phase("multichip-train-500k", torch):
        mctrain = phase_multichip_train(torch, gt, scene500, card)
    del scene500
    torch.cuda.empty_cache()

    with Phase("formats-2m", torch):
        formats_res = phase_formats_2m(torch, gt, card)
        torch.cuda.empty_cache()

    with Phase("colmap-fit", torch):
        colmap_res = phase_colmap_fit(torch, gt, card)

    with Phase("blender-fit", torch):
        blender_res = phase_blender_fit(torch, gt, card)
        torch.cuda.empty_cache()

    with Phase("viewer-2m", torch):
        viewer_res = phase_viewer_2m(torch, gt, card, fit_app_res["poses_dataset"])
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
        "launches": (res3m["kernel_launches"] + formats_res["kernel_launches"]
                     + colmap_res["kernel_launches"]["tile_render2"]
                     + viewer_res["kernel_launches"]["tile_render2"]
                     + mc3m["kernel_launches"] + native_res["kernel_launches"]),
        "launches_by_phase": {"full-3m": res3m["kernel_launches"],
                              "multichip-3m (all ranks)": mc3m["kernel_launches"],
                              "native-io": native_res["kernel_launches"],
                              "formats-2m": formats_res["kernel_launches"],
                              "colmap-fit (apps/eval --path packed)":
                                  colmap_res["kernel_launches"]["tile_render2"],
                              "viewer-2m": viewer_res["kernel_launches"]["tile_render2"]},
        "max_abs_err": max(max_err, formats_res["kernel_vs_plain_max_abs"]),
        "ms": res3m["kernel_ms_median"],
        "plain_ms": plain_ms,
        "bound_ms": res3m["bound_ms"],
        "bound_by": res3m["bound_by"],
        "library_ms": None,
        "pairs": res3m["pairs"],
        "shape": "3M splats, 1920x1080, 32x32 tiles, chunk 256",
        "plain_scope": f"{len(tiles)} tiles of that frame (no yardstick)",
        "kernel_ms_same_tiles": kernel_tiles_ms,
        "trained_500k": {"ms": res500["kernel_ms_median"],
                         "launches": res500["kernel_launches"],
                         "bound_ms": res500["bound_ms"],
                         "bound_by": res500["bound_by"]},
        "trained_2m": {"ms": formats_res["kernel_ms_frame0"],
                       "frame_ms_median": formats_res["frame_ms_median"],
                       "launches": formats_res["kernel_launches"],
                       "bound_ms": formats_res["bound_ms"],
                       "bound_by": formats_res["bound_by"],
                       "plain_ms_32_tiles": formats_res["plain_ms_32_tiles"]},
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
        "device_ms": lookup_res["rect_cutoff"]["device_ms"],
        "library_device_ms": lookup_res["rect_cutoff"]["library_device_ms"],
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
        "launches": (train_res["kernel_launches"][f"tile_train_{kind}"]
                     + colmap_res["kernel_launches"][f"tile_train_{kind}"]
                     + blender_res["kernel_launches"][f"tile_train_{kind}"]
                     + viewer_res["kernel_launches"][f"tile_train_{kind}"]
                     + mctrain["launches"][f"tile_train_{kind}"]),
        "launches_by_phase": {
            "train-500k": train_res["kernel_launches"][f"tile_train_{kind}"],
            "multichip-train-500k (all ranks)": mctrain["launches"][f"tile_train_{kind}"],
            "colmap-fit": colmap_res["kernel_launches"][f"tile_train_{kind}"],
            "blender-fit": blender_res["kernel_launches"][f"tile_train_{kind}"],
            "viewer-2m (apps/fit --serve)":
                viewer_res["kernel_launches"][f"tile_train_{kind}"]},
        "launches_counted": "calls; each launches the kernel's passes",
        "kernels_launched": train_res["kernels_launched_by_the_calls"][f"tile_train_{kind}"],
        "kernel_launches_per_call": train_times["kernel_launches_per_call"][kind],
        "pass_device_ms": train_times["pass_device_ms"][kind],
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
        "fit_launches": fit_res["train_kernel_calls_fit"][f"tile_train_{kind}"],
    } for kind, line in (("fwd", 154), ("bwd", 295))] + [{
        "name": "segment_sum",
        "route": "cuda",
        "source": "gaussianrenderer_tpu_torch/csrc/segment_sum.cu",
        "replaces": "gaussianrenderer_tpu/ops/compositing.py:107",
        "replaces_note": ("no TPU kernel: the JAX package's transpose of the training "
                          "gather, _gather_rows_seg_bwd, is XLA's sort and cumsum"),
        "launches": train_res["segment_sum_launches"],
        "launches_by_phase": {"train-500k": train_res["segment_sum_launches"],
                              "fit-500k": fit_res["train_kernel_calls_fit"]["segment_sum"]},
        "max_abs_err": train_times["segment_sum"]["max_abs_err"],
        "ms": train_times["segment_sum"]["ms"],
        "argsort_route_ms": train_times["segment_sum"]["argsort_route_ms"],
        "device_ms": train_times["segment_sum"]["device_ms"],
        "burst_ms": train_times["segment_sum"]["burst_ms"],
        "plain_ms": train_times["segment_sum"]["plain_ms"],
        "bound_ms": train_times["segment_sum"]["bound_ms"],
        "bound_by": train_times["segment_sum"]["bound_by"],
        "library_ms": train_times["segment_sum"]["library_ms"],
        "library_call": train_times["segment_sum"]["library_call"],
        "shape": (f"{train_times['segment_sum']['rows']} rows of 16 f32 into "
                  f"{train_times['segment_sum']['segments']} splats (train-500k first step)"),
    }, {
        "name": "prng",
        "route": "cuda",
        "source": "gaussianrenderer_tpu_torch/csrc/prng.cu",
        "replaces": "gaussianrenderer_tpu/train.py:809",
        "replaces_note": ("no TPU kernel: the JAX package's densify draw, "
                          "jax.random.normal(PRNGKey(seed), (n, 3)), is XLA's elementwise "
                          "threefry2x32, uniform and erf_inv"),
        "launches": fit_res["train_kernel_calls_fit"]["prng"],
        "launches_by_phase": {"fit-500k": fit_res["train_kernel_calls_fit"]["prng"],
                              "gemm (apps/matrix_test's bf16 inputs)": gemm_res["prng_launches"]},
        "max_abs_err": draw_res["densify_draw"]["max_abs_err"],
        "normal_ulp_max_vs_plain": draw_res["densify_draw"]["normal_ulp_max_vs_plain"],
        "ms": draw_res["densify_draw"]["ms"],
        "device_ms": draw_res["densify_draw"]["device_ms"],
        "back_to_back_ms": draw_res["densify_draw"]["back_to_back_ms"],
        "plain_ms": draw_res["densify_draw"]["plain_ms"],
        "bound_ms": draw_res["densify_draw"]["bound_ms"],
        "bound_by": draw_res["densify_draw"]["bound_by"],
        "library_ms": None,
        "torch_randn_ms": draw_res["densify_draw"]["torch_randn_ms"],
        "shape": f"{tuple(draw_res['densify_draw']['shape'])} f32 normals (fit-500k's episodes)",
    }] + [{
        "name": "matmul_sm90",
        "route": "cuda",
        "source": "gaussianrenderer_tpu_torch/csrc/matmul.cu",
        "replaces": "gaussianrenderer_tpu/ops/pallas/matmul.py:22",
        "launches": gemm_res["launches"]["sm90"],
        "max_abs_err": gemm_res["max_abs_err"]["sm90"],
        "ms": gemm_res["ms"],
        "plain_ms": gemm_res["plain_ms"],
        "bound_ms": gemm_res["bound_ms"],
        "bound_by": gemm_res["bound_by"],
        "library_ms": gemm_res["library_ms"],
        "shape": gemm_res["shape"],
        "library_call": "torch.mm(a, b, out_dtype=torch.float32)",
        "launches_in": "two apps/matrix_test runs (random, --ones), N 8192",
        "kernel_launches_per_call": 1,
    }, {
        "name": "matmul_packed",
        "route": "cuda",
        "source": "gaussianrenderer_tpu_torch/csrc/matmul.cu",
        "replaces": "gaussianrenderer_tpu/ops/pallas/matmul.py:22",
        "launches": gemm_res["launches"]["packed"],
        "max_abs_err": gemm_res["max_abs_err"]["packed"],
        "ms": gemm_res["packed"]["ms"],
        "device_ms": gemm_res["packed"]["device_ms"],
        "burst_ms": gemm_res["packed"]["burst_ms"],
        "plain_ms": gemm_res["packed"]["plain_ms"],
        "bound_ms": gemm_res["packed"]["bound_ms"],
        "bound_by": gemm_res["packed"]["bound_by"],
        "library_ms": gemm_res["packed"]["library_ms"],
        "shape": gemm_res["packed"]["shape"],
        "library_call": "torch.mm(a, b, out_dtype=torch.float32)",
        "launches_in": (f"one apps/matrix_test run at N {GEMM_ODD_N} (shapes TMA cannot take: "
                        "a pack kernel, then the product kernel)"),
        "odd_small": gemm_res["packed"]["odd_small"],
        "launches_counted": "calls; each launches the pack kernel, then the product kernel",
        "kernel_launches_per_call": 2,
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
        "kernel_launches": sort_res["kernel_launches"],
        "kernel_launches_per_call": {run: t["kernel_launches_per_call"]
                                     for run, t in sort_res["runs"].items()},
        "runs": {run: {k: t[k] for k in ("c", "ms", "library_ms", "bound_ms")}
                 for run, t in sort_res["runs"].items()},
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
    if len(sys.argv) == 3 and sys.argv[1] == "--train-times":
        sys.exit(train_times(sys.argv[2]))
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--train-turns":
        if len(sys.argv) == 4 and sys.argv[3] != "--same-bits":
            sys.exit(f"chip_smoke: unknown argument {sys.argv[3]}")
        sys.exit(train_turns(sys.argv[2], same_bits=len(sys.argv) == 4))
    sys.exit(main())
