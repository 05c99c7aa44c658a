"""Training demo: fit a scene to target renders, with adaptive density
control (the JAX package's ``apps/train_test``).

A ground-truth scene renders target frames from a few orbit poses; a
perturbed copy is optimized toward them with the densifying Adam/MSE step
(``train._make_step_fn(densify=True)``), and ``densify_step`` recycles
dead splats into high-gradient donors every ``--densify-every`` steps.

Prints each episode, the loss trajectory and the final PSNR against the
target frame; exits 0 when the loss fell and every episode recycled no
more slots than were dead. ``--device`` (default ``cuda``) picks the
device; ``cpu`` runs the kernels' plain versions.
"""

import argparse
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=400, help="splat budget")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--poses", type=int, default=3)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument(
        "--optimizer", default="adam", choices=["adam", "3dgs"],
        help="adam: one global --lr; 3dgs: the paper's per-group rates "
        "(positions decayed, SH bands split, opacity/scale/quat groups)",
    )
    ap.add_argument("--densify-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from gaussianrenderer_tpu_torch._device import resolve_device
    from gaussianrenderer_tpu_torch.config import RenderConfig
    from gaussianrenderer_tpu_torch.scene.camera import Camera
    from gaussianrenderer_tpu_torch.scene.io import make_random_scene
    from gaussianrenderer_tpu_torch.train import (
        DensifyState,
        SceneParams,
        _make_step_fn,
        densify_step,
        make_3dgs_optimizer,
        make_optimizer,
        mse_loss,
        psnr,
        render_for_training,
    )

    dev = resolve_device(args.device)
    cfg = RenderConfig(height=args.height, width=args.width, compositor="xla",
                       diff_max_chunks=8)

    def pose(i: int) -> Camera:
        cam = Camera()
        cam.set_position([0.0, 0.0, 5.0])
        cam.set_look_at([0.0, 0.0, 0.0])
        cam.set_fov_y(60.0)
        cam.set_aspect_ratio(args.width / args.height)
        cam.set_clipping_planes(0.2, 100.0)
        cam.update_camera_matrices()
        cam.orbit(12.0 * i, 4.0 * i)
        cam.update_camera_matrices()
        return cam

    # Ground truth and its target frames.
    truth = make_random_scene(args.n, seed=args.seed + 1, scale_range=(0.05, 0.2),
                              device=dev)
    truth_params = SceneParams.from_scene(truth)
    cams = [pose(i).params(cfg.k_sigma, device=dev) for i in range(args.poses)]
    with torch.no_grad():
        targets = [render_for_training(truth_params, c, cfg) for c in cams]

    # Start: same budget, other positions.
    start = make_random_scene(args.n, seed=args.seed + 2, scale_range=(0.05, 0.2),
                              device=dev)
    params = SceneParams.from_scene(start)
    if args.optimizer == "3dgs":
        extent = float(start.positions.abs().max())
        optimizer = make_3dgs_optimizer(scene_extent=extent,
                                        position_lr_max_steps=args.steps)
    else:
        optimizer = make_optimizer(args.lr)
    opt_state = optimizer.init(params)
    dstate = DensifyState.zero(args.n, device=dev)

    # The shared densifying step body (view-space ADC gradients).
    step = _make_step_fn(cfg, optimizer, mse_loss, timed=False, densify=True)

    losses = []  # 0-d device tensors, read once at the end
    episodes = []
    for s in range(args.steps):
        i = s % args.poses
        params, opt_state, dstate, loss, _needed = step(
            params, opt_state, dstate, cams[i], targets[i])
        losses.append(loss)
        if (s + 1) % args.densify_every == 0:
            params, opt_state, dstate, info = densify_step(
                params, opt_state, dstate, seed=s + 1)
            rec, dead = torch.stack([info["recycled"], info["dead"]]).tolist()
            episodes.append((rec, dead))
            print(f"step {s + 1}: densify recycled={rec} dead={dead}")
    losses = torch.stack(losses).tolist()

    with torch.no_grad():
        fb = render_for_training(params, cams[0], cfg)
    final_psnr = psnr(fb.cpu().numpy(), targets[0].cpu().numpy())
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.5f} "
          f"({len(losses)} steps, {args.poses} poses)")
    print(f"final PSNR vs target pose 0: {final_psnr:.2f} dB")

    ok = losses[-1] < losses[0]
    for rec, dead in episodes:
        ok = ok and 0 <= rec <= dead
    if not ok:
        print("FAIL: loss did not decrease or densify bookkeeping broken",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
