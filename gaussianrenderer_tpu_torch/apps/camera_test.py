"""Camera smoke (reference ``camera_test.cpp``)."""

import argparse


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from gaussianrenderer_tpu_torch.scene.camera import Camera

    cam = Camera()
    cam.set_fov_y(120.0)
    cam.update_camera_matrices()
    cam.update_frustum_planes()
    # The matrices the renderer takes, on the device.
    cam.params(device=args.device)
    print("view:\n", cam.view)
    print("proj:\n", cam.proj)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
