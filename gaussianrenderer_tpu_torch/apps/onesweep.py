"""Sort correctness harness (reference ``onesweep.cpp`` parity).

Validates the packed single-key sort and the LSD radix composition against
the 2-key oracle over consecutive or geometric size ranges, printing the
first mismatch index/values, honoring ``--stop_on_fail``, and exiting with
a pass-count-based code (``onesweep.cpp:216-217``).
"""

import argparse
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minN", type=int, default=1000)
    ap.add_argument("--maxN", type=int, default=200_000)
    ap.add_argument("--mode", choices=["geometric", "consecutive"], default="geometric")
    ap.add_argument("--growth", type=float, default=1.7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stop_on_fail", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from gaussianrenderer_tpu_torch._device import resolve_device
    from gaussianrenderer_tpu_torch.ops.sort import (
        is_nondecreasing,
        pack_key,
        radix_sort_u32,
        sort_packed,
        sort_two_key,
    )

    dev = resolve_device(args.device)
    sizes = []
    if args.mode == "geometric":
        n = args.minN
        while n <= args.maxN:
            sizes.append(int(n))
            n = int(n * args.growth) + 1
    else:
        sizes = list(range(args.minN, min(args.minN + 64, args.maxN)))

    rng = np.random.default_rng(args.seed)
    passed = failed = 0
    for N in sizes:
        tiles = torch.from_numpy(rng.integers(0, 2048, N, dtype=np.int32)).to(dev)
        depths = torch.from_numpy(
            rng.integers(0, 1 << 21, N, dtype=np.uint32).astype(np.int64)
        ).to(dev)
        vid = torch.arange(N, dtype=torch.int32, device=dev)
        key = pack_key(tiles, depths, 21)

        kp, _ = sort_packed(key, vid)
        kh, kl, _ = sort_two_key(tiles, depths, vid)
        key_o = pack_key(kh, kl, 21)
        kr = radix_sort_u32(key, vid)[0]

        ok = bool(is_nondecreasing(kp))
        ok &= bool(torch.equal(kp, key_o))
        ok &= bool(torch.equal(kr, key_o))
        if ok:
            passed += 1
            print(f"N={N}: PASS")
        else:
            failed += 1
            a = kp.cpu().numpy()
            b = key_o.cpu().numpy()
            bad = np.nonzero(a != b)[0]
            i = int(bad[0]) if bad.size else -1
            print(
                f"N={N}: FAIL first mismatch at {i}: "
                f"packed={a[i] if i >= 0 else '-'} oracle={b[i] if i >= 0 else '-'}"
            )
            if args.stop_on_fail:
                break
    print(f"{passed} passed, {failed} failed")
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
