"""gr-eval: render a trained scene against a capture dataset and report
PSNR/SSIM (the JAX package's ``apps/eval``).

    python -m gaussianrenderer_tpu_torch.apps.eval scene.ply DATASET_DIR \
        --holdout-every 8 --out-dir eval/

Loads any scene format (.ply, .gsz or .splat), renders every dataset view
and prints per-view and mean PSNR/SSIM and one JSON line. ``--path
train`` (the default) renders through the training compositor (the train
forward kernel, as ``apps/fit``'s final report does); ``--path packed``
through the ``make_renderer`` session (the packed compositor kernel),
whose emission never overflows, so ``overflow_views`` is always 0.
``--holdout-every N`` scores every Nth view (the views ``apps/fit
--holdout-every N`` never trained on). ``--out-dir`` writes
``renders/*.png`` and ``gt/*.png`` pairs. ``--device`` (default
``cuda``) picks the device; ``cpu`` runs the kernels' plain versions.
"""

import argparse
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene", help="trained scene (.ply, .gsz, or .splat)")
    ap.add_argument("dataset", help="COLMAP workspace, transforms*.json "
                    "(Blender/NeRF-synthetic) dir, or poses.json dir")
    ap.add_argument("--split", default=None, metavar="NAME",
                    help="transforms*.json datasets: score this split "
                    "(e.g. 'test' for transforms_test.json — the "
                    "upstream NeRF-synthetic eval protocol); default: "
                    "the train split / splitless transforms.json")
    ap.add_argument("--background", default=None, metavar="COLOR",
                    help="composite renders AND RGBA targets over this "
                    "color ('white', 'black', or r,g,b in [0,1]) — match "
                    "what the scene was trained with")
    ap.add_argument("--holdout-every", type=int, default=0,
                    help="evaluate only every Nth view (the upstream "
                    "llffhold test split); 0 = all views")
    ap.add_argument("--out-dir", default=None,
                    help="write renders/*.png and gt/*.png pairs here")
    ap.add_argument("--height", type=int, default=None,
                    help="render height (default: dataset's)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("-r", "--downscale", type=int, default=1,
                    help="score at the dataset resolution / N (the "
                    "upstream -r flag; COLMAP and transforms datasets "
                    "resize same-aspect)")
    ap.add_argument("--sh-degree", type=int, default=None,
                    help="default: the scene's stored degree")
    ap.add_argument("--ewa-dilation", type=float, default=0.0,
                    help="match the value the scene was trained with")
    ap.add_argument("--antialias", action="store_true",
                    help="upstream antialiasing (opacity compensation)")
    ap.add_argument("--path", default="train",
                    choices=["train", "packed"],
                    help="'train' scores through the training/eval "
                    "compositor (comparable to gr-fit's report); "
                    "'packed' scores the deployed inference path "
                    "(auto-calibrated tiers — evaluate what you ship)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import json
    import os

    from gaussianrenderer_tpu_torch._device import resolve_device
    from gaussianrenderer_tpu_torch.config import RenderConfig, parse_color
    from gaussianrenderer_tpu_torch.scene.io import load_scene
    from gaussianrenderer_tpu_torch.train import (
        SceneParams,
        dataset_image_shape,
        evaluate,
        load_views,
    )

    dev = resolve_device(args.device)
    # The stored degree: a degree-3 scene must not be scored as its
    # degree-2 truncation.
    scene = load_scene(args.scene, max_sh_degree=None, device=dev)
    if args.sh_degree is None:
        args.sh_degree = scene.sh_degree

    if args.height is None or args.width is None:
        shape = dataset_image_shape(args.dataset)
        d = max(args.downscale, 1)
        args.height = args.height or shape[0] // d
        args.width = args.width or shape[1] // d

    cfg = RenderConfig(height=args.height, width=args.width,
                       sh_degree=args.sh_degree,
                       ewa_dilation=args.ewa_dilation,
                       ewa_compensate=args.antialias,
                       background=parse_color(args.background))
    # stride picks the split before loading: only the scored views' images
    # are read.
    views = load_views(args.dataset, cfg, stride=args.holdout_every or 1,
                       split=args.split, device=dev)
    if not views:
        raise SystemExit("no views in the dataset"
                         + (" split" if args.holdout_every else ""))
    print(f"{len(views)} views at {args.width}x{args.height}, "
          f"SH degree {args.sh_degree}, "
          f"{scene.num_gaussians} gaussians", flush=True)

    if args.out_dir:
        from PIL import Image

        from gaussianrenderer_tpu_torch.render import framebuffer_to_image

        os.makedirs(os.path.join(args.out_dir, "renders"), exist_ok=True)
        os.makedirs(os.path.join(args.out_dir, "gt"), exist_ok=True)

    params = None
    render_fn = None
    overflow_views = []
    if args.path == "packed":
        from gaussianrenderer_tpu_torch.render import make_renderer

        # auto_tier and scene_path are inert in the port (no tier ladder).
        render_packed = make_renderer(scene, cfg, auto_tier=True, scene_path=args.scene)

        def render_fn(cam, tv):
            fb, stats = render_packed(cam, tv)
            if bool(stats.overflow):
                overflow_views.append(True)
                print("      overflow (truncated coverage)", flush=True)
            return fb[:3]
    else:
        params = SceneParams.from_scene(scene)

    def per_view(i, fb, target, row):
        print(f"view {i:4d}: PSNR {row['psnr']:6.2f} dB  "
              f"SSIM {row['ssim']:.4f}", flush=True)
        if args.out_dir:
            Image.fromarray(framebuffer_to_image(fb)).save(
                os.path.join(args.out_dir, "renders", f"{i:05d}.png"))
            Image.fromarray(framebuffer_to_image(target)).save(
                os.path.join(args.out_dir, "gt", f"{i:05d}.png"))

    result = evaluate(params, views, cfg, render_fn=render_fn, per_view_fn=per_view)
    report = {
        "psnr": result["psnr"],
        "ssim": result["ssim"],
        "views": len(result["per_view"]),
        "num_gaussians": int(scene.num_gaussians),
        "path": args.path,
    }
    if args.path == "packed":
        report["overflow_views"] = len(overflow_views)
    print(f"mean: PSNR {report['psnr']:.2f} dB  SSIM {report['ssim']:.4f}",
          flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
