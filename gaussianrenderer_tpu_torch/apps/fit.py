"""gr-fit: train a 3DGS scene from a capture dataset directory (the JAX
package's ``apps/fit``).

    python -m gaussianrenderer_tpu_torch.apps.fit DATASET_DIR --out scene.ply \
        --n 100000 --steps 5000

DATASET_DIR is a COLMAP workspace (``sparse/0/{cameras,images,
points3D}.bin`` + ``images/``), a Blender / NeRF-synthetic / instant-ngp /
D-NeRF ``transforms*.json`` layout (``--background white`` for the
white-background sets), or a ``poses.json`` + targets directory in the
``train.load_views`` format. Initialization: SfM points for COLMAP
captures (``--init sfm``, their default), random inside a camera-scaled
box otherwise, or ``--init scene.ply|.gsz|.splat`` to refine a scene. Fits
with the 3DGS per-group schedule, adaptive density control and periodic
opacity resets; writes the fitted scene as a 3DGS PLY and prints the
final (and held-out) PSNR/SSIM. ``--serve PORT`` serves a live training
monitor (``web_viewer.TrainMonitor``: the latest snapshot of the first
view and the loss; 0 picks a free port) with a snapshot every
``--serve-every`` steps and one after the fit. ``--device`` (default
``cuda``) picks the device; ``cpu`` runs the kernels' plain versions.
"""

import argparse
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dataset", help="COLMAP workspace, transforms*.json "
                    "(Blender/NeRF-synthetic) dir, or poses.json + targets")
    ap.add_argument("--out", default="fitted.ply")
    ap.add_argument("--n", type=int, default=100_000, help="splat budget")
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--height", type=int, default=None,
                    help="render height (default: first target's)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("-r", "--downscale", type=int, default=1,
                    help="train at the dataset resolution / N (the "
                    "upstream -r flag; COLMAP and transforms datasets "
                    "resize same-aspect)")
    ap.add_argument("--init", default=None, help="scene to refine (PLY or "
                    ".gsz), or 'sfm' to seed from the COLMAP points3D "
                    "cloud (default for COLMAP datasets); random init "
                    "otherwise")
    ap.add_argument("--sh-degree", type=int, default=2,
                    help="SH degree of the fitted scene")
    ap.add_argument("--loss", default="l1_dssim", choices=["l1_dssim", "mse"])
    ap.add_argument("--ewa-dilation", type=float, default=0.0,
                    help="train with the upstream EWA low-pass (px²; "
                    "upstream 3DGS uses 0.3) — render the fitted scene "
                    "with the same value")
    ap.add_argument("--antialias", action="store_true",
                    help="train in upstream antialiasing mode (opacity "
                    "compensation; needs --ewa-dilation)")
    ap.add_argument("--holdout-every", type=int, default=0,
                    help="withhold every Nth view from training and "
                    "report held-out PSNR/SSIM (the upstream llffhold "
                    "eval protocol); 0 = train on all views")
    ap.add_argument("--densify-every", type=int, default=300)
    ap.add_argument("--opacity-reset-every", type=int, default=1500)
    ap.add_argument("--sh-warmup", type=int, default=0, metavar="N",
                    help="unlock one SH band every N steps starting from "
                    "degree 0 (upstream 3DGS's oneupSHdegree schedule, "
                    "N=1000 there); 0 = train all bands from step 0")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="resume a --checkpoint-dir step_NNNNNN directory "
                    "(same dataset/budget flags); continues every cadence "
                    "from the recorded step")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve a live training monitor on this port "
                    "(latest snapshot render + loss; 0 picks a free "
                    "port) — the remote-training-viewer workflow")
    ap.add_argument("--serve-every", type=int, default=100,
                    help="steps between monitor snapshots (each one "
                    "renders a full preview frame)")
    ap.add_argument("--background", default=None, metavar="COLOR",
                    help="composite renders over this color ('white', "
                    "'black', or r,g,b in [0,1]); RGBA dataset targets "
                    "composite over the same color (the upstream "
                    "--white_background convention for NeRF-synthetic "
                    "captures)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import os

    import numpy as np
    import torch

    from gaussianrenderer_tpu_torch._device import resolve_device
    from gaussianrenderer_tpu_torch.config import RenderConfig, parse_color
    from gaussianrenderer_tpu_torch.scene import colmap
    from gaussianrenderer_tpu_torch.scene.io import load_scene, make_random_scene, save_ply
    from gaussianrenderer_tpu_torch.train import (
        SceneParams,
        dataset_image_shape,
        evaluate,
        fit_scene,
        l1_dssim_loss,
        load_views,
        make_3dgs_optimizer,
        mse_loss,
    )

    dev = resolve_device(args.device)
    is_colmap = not os.path.isfile(
        os.path.join(args.dataset, "poses.json")
    ) and colmap.is_colmap_dir(args.dataset)

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
    views = load_views(args.dataset, cfg, device=dev)
    heldout = []
    if args.holdout_every:
        # The upstream 3DGS eval protocol (llffhold): every Nth view is a
        # test view, never trained on.
        heldout = views[:: args.holdout_every]
        views = [v for i, v in enumerate(views)
                 if i % args.holdout_every != 0]
        if not views:
            raise SystemExit("--holdout-every leaves no training views")
    print(f"{len(views)} train / {len(heldout)} held-out views at "
          f"{args.width}x{args.height}", flush=True)

    if args.init is None and is_colmap:
        args.init = "sfm"  # the upstream 3DGS default for COLMAP captures
    if args.init == "sfm":
        xyz, rgb = colmap.load_colmap_points(args.dataset)
        print(f"SfM init: {xyz.shape[0]} points -> {args.n} splats", flush=True)
        params = colmap.init_from_points(
            xyz, rgb, n=args.n, sh_degree=cfg.sh_degree, seed=args.seed, device=dev
        )
    elif args.init:
        # Load at the requested training degree: a higher-degree init is
        # truncated to what will be trained, a lower-degree one (and any
        # .gsz/.splat, which never pad) gets zero bands to learn into.
        init_scene = load_scene(args.init, max_sh_degree=args.sh_degree, device=dev)
        want = 3 * (args.sh_degree + 1) ** 2
        if init_scene.sh.shape[1] < want:
            init_scene = init_scene._replace(sh=torch.nn.functional.pad(
                init_scene.sh, (0, want - init_scene.sh.shape[1])))
        params = SceneParams.from_scene(init_scene)
    else:
        # Random init spanning the camera rig's bounding box, at the
        # trained degree (extra bands would get no gradient).
        cams = np.stack([v[0].position.cpu().numpy() for v in views])
        extent = float(np.abs(cams).max()) or 2.0
        params = SceneParams.from_scene(
            make_random_scene(args.n, seed=args.seed, extent=extent,
                              sh_degree=args.sh_degree, device=dev))
    # NaN-skipping, unlike the JAX app's max: a splat with NaN parameters
    # (data/trained_500k.ply has three) must not make every position's
    # learning rate NaN.
    extent = float(np.nanmax(np.abs(params.positions.cpu().numpy())))

    loss_fn = l1_dssim_loss if args.loss == "l1_dssim" else mse_loss

    snapshot_fn = None
    if args.serve is not None:
        from gaussianrenderer_tpu_torch.render import framebuffer_to_image
        from gaussianrenderer_tpu_torch.train import render_for_training
        from gaussianrenderer_tpu_torch.web_viewer import TrainMonitor

        monitor = TrainMonitor(port=args.serve).start()
        print(f"monitor: {monitor.url}", flush=True)
        preview_cam = views[0][0]

        def snapshot_fn(step, p, loss):
            with torch.no_grad():
                fb = render_for_training(p, preview_cam, cfg)
            monitor.update(
                step, loss, framebuffer_to_image(fb),
                num_gaussians=int(p.positions.shape[0]),
                total_steps=args.steps,
            )

    params, hist = fit_scene(
        views, cfg, params,
        steps=args.steps,
        optimizer=make_3dgs_optimizer(
            scene_extent=extent, position_lr_max_steps=args.steps
        ),
        loss_fn=loss_fn,
        densify_every=args.densify_every,
        opacity_reset_every=args.opacity_reset_every,
        sh_warmup_every=args.sh_warmup,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume_from=args.resume,
        log_fn=lambda s, l: print(f"step {s}: loss {l:.5f}", flush=True),
        snapshot_fn=snapshot_fn,
        snapshot_every=args.serve_every if snapshot_fn else 0,
    )
    if snapshot_fn is not None and hist["losses"]:
        snapshot_fn(args.steps, params, hist["losses"][-1])  # final state
    report = evaluate(params, views, cfg)
    print(f"final: PSNR {report['psnr']:.2f} dB  SSIM {report['ssim']:.4f}",
          flush=True)
    if heldout:
        test_report = evaluate(params, heldout, cfg)
        print(
            f"held-out: PSNR {test_report['psnr']:.2f} dB  "
            f"SSIM {test_report['ssim']:.4f}",
            flush=True,
        )
    save_ply(params.to_scene(), args.out)
    print(f"wrote {args.out}", flush=True)
    k = max(len(views), 1)
    print(
        f"loss: first-epoch mean {np.mean(hist['losses'][:k]):.5f} -> "
        f"last-epoch mean {np.mean(hist['losses'][-k:]):.5f}",
        flush=True,
    )
    return 0 if np.isfinite(hist["losses"]).all() else 1


if __name__ == "__main__":
    sys.exit(main())
