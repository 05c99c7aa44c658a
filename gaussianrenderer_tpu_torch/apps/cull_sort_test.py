"""gr-render: the main interactive app (the JAX package's
``apps/cull_sort_test``, reference ``cull_sort_test.cpp``).

The reference main's session constants (``cull_sort_test.cpp:13-68``): a
2000×1500 canvas, the camera at (−1.5, −1.5, −3) with world-up −Y, fovY
120°, clip planes (2.5, 100). Loads a scene (.ply, .gsz or .splat) and
renders an orbit loop printing an EMA frame-time/FPS line every 60
frames, or serves the browser viewer.

    python -m gaussianrenderer_tpu_torch.apps.cull_sort_test scene.ply \
        [--frames N] [--serve] [--width W --height H] [--tiles T] \
        [--synthetic N] [--device cpu]

``--tiles 0`` (the default) takes 32×32 tiles; the reference's 50×50 grid
(``--tiles 50``) is 40×30-pixel tiles at 2000×1500, which the packed
records cannot describe, so those frames take the f32 tile-sort path.
"""

import argparse
import sys


def session_canvas(width: int, height: int, tiles: int = 0, device="cuda", **cfg_kwargs):
    """A Canvas with the reference session's camera, before any scene."""
    from gaussianrenderer_tpu_torch.viewer import Canvas

    canvas = Canvas(height=height, width=width, tile_x=tiles, tile_y=tiles, device=device,
                    **cfg_kwargs)
    canvas.init()

    # Reference camera setup (cull_sort_test.cpp:25-31, 44-45).
    cam = canvas.camera
    cam.set_world_up([0.0, -1.0, 0.0])
    cam.set_fov_y(120.0)
    cam.set_clipping_planes(2.5, 100.0)
    cam.set_position([-1.5, -1.5, -3.0])
    cam.set_look_at([0.0, 0.0, 0.0])
    cam.set_aspect_ratio(width / height)
    cam.update_camera_matrices()
    cam.update_frustum_planes()
    canvas.settings.fov_y = 120.0
    return canvas


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ply", nargs="?", help="scene path (.ply, .gsz or .splat)")
    ap.add_argument("--synthetic", type=int, default=0, help="use a random scene of N splats")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--width", type=int, default=2000)
    ap.add_argument("--height", type=int, default=1500)
    ap.add_argument("--tiles", type=int, default=0, help="explicit NxN tile grid (reference used 50)")
    ap.add_argument("--serve", action="store_true", help="start the browser viewer instead of the headless loop")
    ap.add_argument("--screenshot", default=None, metavar="PNG",
                    help="save the last headless frame as PNG")
    ap.add_argument("--port", type=int, default=8800)
    ap.add_argument("--ewa-dilation", type=float, default=0.0,
                    help="EWA low-pass (px²); 0.3 = upstream 3DGS")
    ap.add_argument("--antialias", action="store_true",
                    help="upstream antialiasing opacity compensation "
                    "(for scenes trained with it; needs --ewa-dilation)")
    ap.add_argument("--background", default=None, metavar="COLOR",
                    help="composite frames over this color ('white', "
                    "'black', or r,g,b in [0,1]) — match what the scene "
                    "was trained with")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from gaussianrenderer_tpu_torch.config import parse_color
    from gaussianrenderer_tpu_torch.scene.io import make_random_scene

    canvas = session_canvas(
        args.width, args.height, args.tiles, device=args.device,
        ewa_dilation=args.ewa_dilation,
        ewa_compensate=args.antialias,
        background=parse_color(args.background),
    )

    if args.synthetic:
        canvas.set_scene(make_random_scene(args.synthetic, seed=0, device=canvas.device))
    elif args.ply:
        canvas.load_gaussians(args.ply)
    else:
        print("need a PLY path or --synthetic N", file=sys.stderr)
        return 2

    if args.serve:
        canvas.serve(port=args.port)
        return 0

    canvas.run_headless(args.frames, orbit_deg_per_frame=1.0)
    if args.screenshot:
        canvas.screenshot(args.screenshot)
        print(f"wrote {args.screenshot}")
    if canvas.timer.ema_ms is not None:
        print(
            f"final: {canvas.timer.ema_ms:.3f} ms/frame "
            f"({1000.0 / canvas.timer.ema_ms:.1f} FPS)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
