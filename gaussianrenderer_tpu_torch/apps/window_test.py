"""Interactive viewer demo (the JAX package's ``apps/window_test``,
reference ``window_test.cpp``): the browser viewer on a synthetic scene,
with orbit, zoom and the settings served over localhost.

    python -m gaussianrenderer_tpu_torch.apps.window_test [--n N] [--port P] \
        [--size S] [--device cpu]
"""

import argparse


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--port", type=int, default=8800)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from gaussianrenderer_tpu_torch.scene.io import make_random_scene
    from gaussianrenderer_tpu_torch.viewer import Canvas

    canvas = Canvas(height=args.size, width=args.size, device=args.device)
    canvas.init()
    canvas.camera.set_position([0.0, 0.0, 6.0])
    canvas.camera.set_fov_y(70.0)
    canvas.camera.set_clipping_planes(0.2, 100.0)
    canvas.camera.update_camera_matrices()
    canvas.set_scene(make_random_scene(args.n, seed=0, device=canvas.device))
    canvas.serve(port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
