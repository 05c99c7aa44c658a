"""Executable apps — the JAX package's harness apps, ported. Run as
``python -m gaussianrenderer_tpu_torch.apps.<name> [--device cpu]``:

  radix_test      sort benchmark sweep with JSONL output
  onesweep        sort correctness harness vs the 2-key oracle
  matrix_test     GEMM benchmark (the CUDA kernel vs torch.mm)
  parser_test     PLY parse smoke
  camera_test     camera construction smoke

Each takes the JAX app's flags and defaults, prints its lines and
returns its exit codes, and adds ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain versions).
"""
