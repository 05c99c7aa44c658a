"""gr-edit: scene editing from the command line (the JAX package's
``apps/edit``).

    python -m gaussianrenderer_tpu_torch.apps.edit out.ply a.ply b.gsz \\
        --rotate 0,1,0,90 --translate 0,0,2 --scale 1.5 \\
        --crop -5,-5,-5,5,5,5 --min-opacity 0.01 --max-scale 2.0

Loads any mix of .ply, .gsz and .splat scenes at their stored SH degree,
merges them (SH degree and time params padded), then applies in order:
the similarity transform (exact per-band SH rotation,
:mod:`scene.edit`), the half-open box crop, the opacity/size prune; and
writes the result in the format the output's extension names. The edit
runs on the host; ``--device`` (default ``cuda``) is where the scenes
are loaded.
"""

import argparse
import sys


def _floats(s: str):
    return [float(x) for x in s.split(",")]


#: options taking a comma-separated number list — see _join_csv_values.
_CSV_OPTS = ("--rotate", "--translate", "--crop")


def _join_csv_values(argv):
    """Rewrite ``--crop -5,-5,-5,5,5,5`` into ``--crop=-5,...``: argparse
    takes a value starting with ``-`` for an unknown option unless it
    parses as one negative number, which a comma list never does."""
    out = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in _CSV_OPTS and i + 1 < len(argv) and argv[i + 1][:1] == "-" \
                and argv[i + 1][1:2].replace(".", "0").isdigit():
            out.append(f"{tok}={argv[i + 1]}")
            i += 2
        else:
            out.append(tok)
            i += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="output scene (.ply, .gsz, or .splat)")
    ap.add_argument("inputs", nargs="+",
                    help="input scenes (merged in order when several)")
    ap.add_argument("--rotate", default=None, metavar="X,Y,Z,DEG",
                    help="axis-angle rotation")
    ap.add_argument("--translate", default=None, metavar="TX,TY,TZ")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="uniform scale factor")
    ap.add_argument("--crop", default=None,
                    metavar="X0,Y0,Z0,X1,Y1,Z1",
                    help="keep splats with center in the half-open box")
    ap.add_argument("--min-opacity", type=float, default=None)
    ap.add_argument("--max-scale", type=float, default=None,
                    help="prune splats with a world extent above this")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(_join_csv_values(sys.argv[1:]))

    from gaussianrenderer_tpu_torch._device import resolve_device
    from gaussianrenderer_tpu_torch.scene import edit
    from gaussianrenderer_tpu_torch.scene.compact import save_compact, save_splat
    from gaussianrenderer_tpu_torch.scene.io import load_scene, save_ply

    dev = resolve_device(args.device)
    scenes = []
    for path in args.inputs:
        # The stored degree: an edit must not truncate a degree-3 band.
        s = load_scene(path, max_sh_degree=None, device=dev)
        print(f"{path}: {s.num_gaussians} gaussians, "
              f"SH degree {s.sh_degree}"
              + (" (spacetime)" if s.is_spacetime else ""), flush=True)
        scenes.append(s)
    scene = scenes[0] if len(scenes) == 1 else edit.merge_scenes(*scenes)
    if len(scenes) > 1:
        print(f"merged: {scene.num_gaussians} gaussians, "
              f"SH degree {scene.sh_degree}", flush=True)

    if args.rotate or args.translate or args.scale != 1.0:
        rotation = None
        if args.rotate:
            vals = _floats(args.rotate)
            if len(vals) != 4:
                raise SystemExit("--rotate needs X,Y,Z,DEG "
                                 "(4 comma-separated numbers)")
            try:
                rotation = edit.axis_angle_rotation(vals[:3], vals[3])
            except ValueError as e:
                raise SystemExit(f"--rotate: {e}")
        translation = None
        if args.translate:
            translation = _floats(args.translate)
            if len(translation) != 3:
                raise SystemExit("--translate needs TX,TY,TZ "
                                 "(3 comma-separated numbers)")
        scene = edit.transform_scene(scene, rotation=rotation,
                                     translation=translation, scale=args.scale)
    if args.crop:
        box = _floats(args.crop)
        if len(box) != 6:
            raise SystemExit("--crop needs 6 comma-separated numbers")
        before = scene.num_gaussians
        scene = edit.crop_scene(scene, box[:3], box[3:])
        print(f"crop: {before} -> {scene.num_gaussians}", flush=True)
    if args.min_opacity is not None or args.max_scale is not None:
        before = scene.num_gaussians
        scene = edit.prune_scene(scene, min_opacity=args.min_opacity or 0.0,
                                 max_scale=args.max_scale)
        print(f"prune: {before} -> {scene.num_gaussians}", flush=True)
    if scene.num_gaussians == 0:
        raise SystemExit("no splats left after editing")

    if args.out.endswith(".gsz"):
        save_compact(scene, args.out)
    elif args.out.endswith(".splat"):
        save_splat(scene, args.out)
    else:
        save_ply(scene, args.out)
    print(f"wrote {args.out} ({scene.num_gaussians} gaussians)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
