"""GEMM benchmark (reference ``matrix_test.cpp`` parity).

Times the blocked GEMM kernel (``ops/cuda/matmul.py``) and
``torch.mm(a, b, out_dtype=torch.float32)`` (cuBLAS, the bar) at a given
N (default 8192, as the reference), prints the device and TFLOP/s, and
checks the kernel against the ones-fill closed form like
``matrix_test.cpp:111-124`` plus a full check against the bar. The random
inputs are the JAX app's, ``jax.random.normal(PRNGKey(0), (n, n),
bfloat16)`` for both ``a`` and ``b`` (``ops/cuda/prng.py``). On the CPU
the bar is ``a.float() @ b.float()`` (``torch.mm``'s ``out_dtype`` runs
only on CUDA) and the kernel's plain version runs.

Times come from CUDA events around back-to-back calls
(``utils.device_time``), so they are not comparable with the JAX app's,
which subtracts a host sync floor from a jitted loop on the TPU.
"""

import argparse
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--bm", type=int, default=512)
    ap.add_argument("--bn", type=int, default=1024)
    ap.add_argument("--bk", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--ones", action="store_true", help="ones-fill spot check")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from gaussianrenderer_tpu_torch.ops.cuda.matmul import matmul_blocked
    from gaussianrenderer_tpu_torch.ops.cuda.prng import normal
    from gaussianrenderer_tpu_torch.utils import device_info, device_time

    info = device_info(args.device)
    dev = torch.device(args.device)
    n = args.n
    print(f"device: {info['device']} ({info['platform']})", file=sys.stderr)

    if args.ones:
        a = torch.ones((n, n), dtype=torch.bfloat16, device=dev)
        b = torch.ones((n, n), dtype=torch.bfloat16, device=dev)
    else:
        # The JAX app's inputs: both from PRNGKey(0), so a equals b.
        a = normal(0, (n, n), dev, torch.bfloat16)
        b = normal(0, (n, n), dev, torch.bfloat16)

    if dev.type == "cuda":
        def bar(a, b):
            return torch.mm(a, b, out_dtype=torch.float32)
    else:
        def bar(a, b):
            return a.float() @ b.float()

    def kernel(a, b):
        return matmul_blocked(a, b, bm=args.bm, bn=args.bn, bk=args.bk)

    out = kernel(a, b)
    ref = bar(a, b)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max()) or 1.0
    ok = err / scale < 1e-2
    if args.ones:
        ok &= float(out[0, 0]) == float(n)
    print(f"correctness: max rel err {err/scale:.2e} -> {'OK' if ok else 'FAIL'}")

    flops = 2.0 * n * n * n
    for name, fn in (("matmul_blocked", kernel), ("torch_mm", bar)):
        ms = device_time(fn, a, b, iters=args.iters)
        # flops/ms/1e9 = flops/(ms/1000)/1e12 = TFLOP/s (the reference
        # prints GFLOP/s, matrix_test.cpp:103-108).
        print(f"{name}: {ms:.3f} ms  {flops / ms / 1e9:.1f} TFLOP/s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
