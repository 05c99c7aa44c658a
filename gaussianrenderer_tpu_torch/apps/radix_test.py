"""Sort benchmark sweep with JSONL output (reference ``radix_test.cpp``).

Sweeps N geometrically over seeds, timing the production packed
single-key sort, the 2-key oracle and the LSD radix composition, with
nondecreasing + match-vs-oracle checks, writing one JSONL record per run.

Usage:
  python -m gaussianrenderer_tpu_torch.apps.radix_test [--minN 1e5]
      [--maxN 4e6] [--growth 2.0] [--seeds 1] [--iters 5]
      [--out build/radix_bench_port.jsonl] [--device cuda]

The default ``--out`` appends under ``build/`` of the working directory,
not to ``radix_bench.jsonl``, which at the repository root holds the JAX
package's TPU runs. Times come from CUDA events around back-to-back calls
(``utils.device_time``) and are not comparable with the TPU rows, which
subtract a host sync floor from a jitted loop; the sync floor is printed
as the JAX app prints it, and nothing subtracts it.
"""

import argparse
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minN", type=float, default=1e5)
    ap.add_argument("--maxN", type=float, default=4e6)
    ap.add_argument("--growth", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default="build/radix_bench_port.jsonl")
    ap.add_argument("--tile-bits", type=int, default=11)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from gaussianrenderer_tpu_torch.ops.sort import (
        is_nondecreasing,
        pack_key,
        radix_sort_u32,
        sort_packed,
        sort_two_key,
    )
    from gaussianrenderer_tpu_torch.utils import JsonlWriter, device_time, measure_floor

    writer = JsonlWriter(args.out, device=args.device)
    dev = torch.device(args.device)
    floor = measure_floor(device=dev)
    print(f"sync floor {floor:.1f} ms", file=sys.stderr, flush=True)

    depth_bits = 32 - args.tile_bits
    sizes = []
    n = args.minN
    while n <= args.maxN:
        sizes.append(int(n))
        n *= args.growth

    ok_all = True
    for seed in range(args.seeds):
        rng = np.random.default_rng(seed)
        for N in sizes:
            tiles = rng.integers(0, 1 << args.tile_bits, N, dtype=np.uint32)
            depths = rng.integers(0, 1 << depth_bits, N, dtype=np.uint32)
            t = torch.from_numpy(tiles.astype(np.int32)).to(dev)
            d = torch.from_numpy(depths.astype(np.int64)).to(dev)
            vid = torch.arange(N, dtype=torch.int32, device=dev)
            key = pack_key(t, d, depth_bits)

            # correctness: packed vs 2-key oracle (the "CUB check")
            kp, vp = sort_packed(key, vid)
            kh, kl, vo = sort_two_key(t, d, vid)
            key_o = pack_key(kh, kl, depth_bits)
            mono = bool(is_nondecreasing(kp))
            match = bool(torch.equal(kp, key_o))
            kr = radix_sort_u32(key, vid)
            radix_match = bool(torch.equal(kr[0], kp))
            ok_all &= mono and match and radix_match

            for algo, fn in (
                ("packed_1key", lambda k: sort_packed(k, vid)),
                ("two_key_oracle", lambda k: sort_two_key(t, d, vid)),
                ("lsd_radix_4x8", lambda k: radix_sort_u32(k, vid)),
            ):
                ms = device_time(fn, key, iters=args.iters)
                writer.write(
                    algo=algo,
                    N=N,
                    seed=seed,
                    device_ms=round(ms, 4),
                    gitems_per_s=round(N / max(ms, 1e-9) / 1e6, 3),
                    nondecreasing=mono,
                    matches_oracle=match,
                    radix_matches=radix_match,
                )
    print("PASS" if ok_all else "FAIL", file=sys.stderr)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
