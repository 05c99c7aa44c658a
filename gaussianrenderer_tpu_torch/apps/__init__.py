"""Executable apps — the JAX package's apps, ported. Run as
``python -m gaussianrenderer_tpu_torch.apps.<name> [--device cpu]``:

  radix_test      sort benchmark sweep with JSONL output
  onesweep        sort correctness harness vs the 2-key oracle
  matrix_test     GEMM benchmark (the CUDA kernel vs torch.mm)
  parser_test     PLY parse smoke
  camera_test     camera construction smoke
  train_test      training demo: densifying steps toward target renders
  fit             gr-fit: fit a scene to a COLMAP, Blender or poses.json dataset
                  (--serve: a live training monitor)
  eval            gr-eval: score a scene against a dataset (PSNR/SSIM)
  edit            gr-edit: merge, transform, crop and prune scenes
  cull_sort_test  gr-render: the reference session's orbit loop, or the
                  browser viewer (--serve)
  window_test     the browser viewer on a synthetic scene

Each takes the JAX app's flags and defaults, prints its lines and
returns its exit codes, and adds ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain versions).
"""
