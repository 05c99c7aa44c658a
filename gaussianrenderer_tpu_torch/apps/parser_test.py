"""PLY parse smoke (reference ``parser_test.cpp``)."""

import argparse
import sys


def main() -> int:
    ap = argparse.ArgumentParser(usage="parser_test <scene.ply> [--device DEVICE]")
    ap.add_argument("path", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.path is None:
        print("usage: parser_test <scene.ply>", file=sys.stderr)
        return 2
    from gaussianrenderer_tpu_torch.scene.io import load_ply

    scene = load_ply(args.path, device=args.device)
    print(
        f"parsed {scene.num_gaussians} gaussians, sh degree {scene.sh_degree}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
