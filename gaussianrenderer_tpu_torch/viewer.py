"""Canvas — the viewer session layer (PyTorch port of ``viewer.py``).

The reference Canvas owns a GLFW window, the per-frame CUDA work, an
ImGui settings panel and input callbacks (``canvas.cpp``). This Canvas
is a headless session object with the same public surface:

* ``Canvas(height, width, tile_x, tile_y)`` (``canvas.cpp:9``);
* ``init()`` — loads (building at first use) the kernel libraries the
  session launches, in a background thread;
* ``load_gaussians(path)`` — hot scene swap (drag-drop, ``canvas.cpp:280-296``);
* ``render()`` — one frame through ``render_frame`` on the canvas's
  device; ``draw()`` — the frame as a displayable uint8 image (the
  reference's D2H → SSBO → fullscreen-quad hop, ``canvas.cpp:337-365``);
* ``on_resize(h, w)`` — dynamic resolution (``canvas.cpp:198-224``);
* ``UiSettings`` — flip-Y, k-sigma (0.1-8), fovY, a tile grid with an X/Y
  lock, the 4D time and the depth view (``canvas.hpp:7-19``);
* orbit, zoom and drag input with the reference's degrees per pixel
  (``canvas.cpp:226-279``), and an EMA frame timer
  (``cull_sort_test.cpp:53-63``).

``serve()`` starts the localhost browser viewer (web_viewer.py), the
display transport in place of OpenGL.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from gaussianrenderer_tpu_torch import _build
from gaussianrenderer_tpu_torch._device import resolve_device
from gaussianrenderer_tpu_torch.config import RenderConfig, UiSettings
from gaussianrenderer_tpu_torch.render import framebuffer_to_image, render_frame, save_png
from gaussianrenderer_tpu_torch.scene.camera import Camera
from gaussianrenderer_tpu_torch.scene.gaussians import GaussianScene
from gaussianrenderer_tpu_torch.scene.io import load_scene
from gaussianrenderer_tpu_torch.utils.timing import FrameTimer

__all__ = ["Canvas", "FrameTimer", "OrbitControls"]


class OrbitControls:
    """Drag-to-orbit state (reference ``render.hpp:11-20``)."""

    def __init__(self, orbit_speed_x: float = 0.25, orbit_speed_y: float = 0.25):
        self.orbit_speed_x = orbit_speed_x  # degrees per pixel
        self.orbit_speed_y = orbit_speed_y
        self.dragging = False
        self._last_xy = (0.0, 0.0)

    def press(self, x: float, y: float) -> None:
        self.dragging = True
        self._last_xy = (x, y)

    def release(self) -> None:
        self.dragging = False

    def move(self, x: float, y: float):
        """Returns (azimuth_deg, elevation_deg) or None if not dragging."""
        if not self.dragging:
            return None
        dx = x - self._last_xy[0]
        dy = y - self._last_xy[1]
        self._last_xy = (x, y)
        return (dx * self.orbit_speed_x, dy * self.orbit_speed_y)


#: The kernel library each compositor launches on the card (render.py);
#: the xla compositor launches none.
COMPOSITOR_LIBRARY = {"packed": "tile_render2", "diff": "tile_train"}


class Canvas:
    """Headless render session with the reference Canvas surface, on
    ``device`` (default ``"cuda"``; ``"cpu"`` runs the kernels' plain
    versions). Extra keyword arguments are ``RenderConfig`` fields
    (``ewa_dilation``, ``background``, ``output_depth``, …); the session
    owns resolution, tiling and fov."""

    def __init__(
        self,
        height: int = 800,
        width: int = 800,
        tile_x: int = 0,
        tile_y: int = 0,
        compositor: str = "packed",
        device="cuda",
        **cfg_kwargs,
    ):
        self.device = resolve_device(device)
        self.settings = UiSettings()
        self._base_cfg = RenderConfig(
            height=height,
            width=width,
            num_tile_x=tile_x,
            num_tile_y=tile_y,
            compositor=compositor,
            **cfg_kwargs,
        )
        self.camera = Camera()
        # Keep the UI fov in sync with the camera default (45°), so the
        # first set_fov() does not jump the view.
        self.settings.fov_y = self.camera.fov_y
        self._scene: Optional[GaussianScene] = None
        self.timer = FrameTimer()
        self.controls = OrbitControls()
        self._fb = None
        self._last_drop: Optional[str] = None
        self._prewarm_thread: Optional[threading.Thread] = None
        self._prewarm_error: Optional[BaseException] = None

    # ------------------------------------------------------------- lifecycle
    def init(self, prewarm: bool = True, resize_buckets=((720, 1280),)) -> None:
        """Reference ``Canvas::init``.

        ``prewarm`` starts a daemon thread that loads, building at first
        use with nvcc, the kernel library of the canvas's compositor, so
        the first frame does not wait for the build. The kernels do not
        depend on the frame's shape: there is nothing per shape to
        compile, and ``resize_buckets`` (the JAX Canvas compiles each) is
        accepted and changes nothing. On the CPU nothing is built and the
        thread ends at once. An error in the thread is kept in
        ``_prewarm_error``; the first frame then builds again and raises
        it."""
        del resize_buckets
        if not prewarm:
            return
        name = COMPOSITOR_LIBRARY.get(self._base_cfg.compositor)

        def work():
            try:
                if self.device.type == "cuda" and name is not None:
                    _build.load(name)
            except Exception as e:  # kept for the caller; the first frame raises again
                self._prewarm_error = e

        self._prewarm_thread = threading.Thread(target=work, daemon=True, name="gr-prewarm")
        self._prewarm_thread.start()

    @property
    def cfg(self) -> RenderConfig:
        """The frame's config: the base config with the UI's tile grid
        (a grid that is not ``packed_compatible``, such as the reference's
        50×50 at 2000×1500, renders on the f32 tile-sort path, as in
        render.py) and, in the depth view, the alpha and depth rows."""
        s = self.settings
        cfg = self._base_cfg
        if s.num_tile_x > 0 or s.num_tile_y > 0:
            cfg = dataclasses.replace(cfg, num_tile_x=s.num_tile_x, num_tile_y=s.num_tile_y)
        if s.view_mode == "depth":
            cfg = dataclasses.replace(cfg, output_alpha=True, output_depth=True)
        return cfg

    # --------------------------------------------------------------- loading
    @property
    def scene(self) -> Optional[GaussianScene]:
        """The loaded scene, resident on the canvas's device: one copy,
        rendered as it is (the port has no separate render layout)."""
        return self._scene

    @scene.setter
    def scene(self, scene: Optional[GaussianScene]) -> None:
        if scene is not None:  # .to() is a no-op for a tensor already there
            scene = GaussianScene(*(None if x is None else x.to(self.device) for x in scene))
        self._scene = scene

    def load_gaussians(self, path: str) -> None:
        """Hot-swap the scene from a ``.ply``, ``.gsz`` or ``.splat`` file
        (reference drag-drop, ``canvas.cpp:280-296``). The file is read
        on the host first, so a file that fails to load leaves the current
        scene in place; the current scene and frame are then dropped
        before the new scene moves to the device, so a swap never holds
        two scenes there. The JAX Canvas also seeds its instance-tier
        ladder from a calibration sidecar; the port emits without static
        lanes and has no sidecar."""
        host = load_scene(path, device="cpu")
        self._scene = self._fb = None
        self.scene = host

    def set_scene(self, scene: GaussianScene) -> None:
        self.scene = scene

    def drop_file(self, path: str) -> None:
        """GLFW drop-callback analog: remembers and loads the last path."""
        self._last_drop = path
        self.load_gaussians(path)

    # --------------------------------------------------------------- controls
    def on_cursor(self, x: float, y: float) -> None:
        delta = self.controls.move(x, y)
        if delta is not None:
            self.camera.orbit(*delta)

    def on_mouse_button(self, pressed: bool, x: float = 0.0, y: float = 0.0) -> None:
        if pressed:
            self.controls.press(x, y)
        else:
            self.controls.release()

    def on_scroll(self, dy: float) -> None:
        self.camera.zoom(dy)

    def on_resize(self, height: int, width: int) -> None:
        """Dynamic resolution (reference ``Canvas::onResize``): the
        config's size and the camera's aspect."""
        self._base_cfg = self._base_cfg.with_resolution(height, width)
        self.camera.set_aspect_ratio(width / height)
        self.camera.update_camera_matrices()

    def set_fov(self, fov_deg: float) -> None:
        self.settings.fov_y = fov_deg
        self.settings.clamp()
        self.camera.set_fov_y(self.settings.fov_y)
        self.camera.update_camera_matrices()
        self.camera.update_frustum_planes()  # fov slider path, canvas.cpp:310-314

    # ---------------------------------------------------------------- render
    def render(self):
        """One frame through ``render_frame``; returns ``(fb, stats)`` with
        the framebuffer on the canvas's device."""
        if self.scene is None:
            raise RuntimeError("no scene loaded — call load_gaussians() first")
        self.settings.clamp()
        cfg = self.cfg
        params = self.camera.params(self.settings.k_sigma, device=self.device)
        tv = self.settings.time_value
        if tv is not None and self.scene.time_params is not None:
            fb, stats = render_frame(self.scene, params, cfg, float(tv))
        else:
            fb, stats = render_frame(self.scene, params, cfg)
        self._fb = fb
        line = self.timer.tick()
        if line:
            print(line, flush=True)
        return fb, stats

    def draw(self, fb=None) -> np.ndarray:
        """The frame for display: (H, W, 3) uint8, Y-flipped per settings.
        In the depth view the expected-depth row is divided by alpha and
        min-max scaled over the covered pixels (alpha > 0.05) to gray,
        uncovered pixels black. The conversion runs on the framebuffer's
        device, and only the uint8 image is copied to the host.

        ``fb`` overrides the framebuffer to draw: the /stream pusher
        passes the previous frame (web_viewer)."""
        if fb is None:
            if self._fb is None:
                self.render()
            fb = self._fb
        if self.settings.view_mode == "depth" and fb.shape[0] >= 5:
            alpha, depth = fb[3], fb[4]
            covered = alpha > 0.05
            nd = torch.where(covered, depth / torch.clamp_min(alpha, 1e-6), 0.0)
            inf = torch.tensor(float("inf"), device=fb.device)
            any_cov = covered.any()
            lo = torch.where(any_cov, torch.where(covered, nd, inf).amin(), 0.0)
            hi = torch.where(any_cov, torch.where(covered, nd, -inf).amax(), 1.0)
            # The span in f64, rounded once to f32, as the JAX Canvas's
            # Python-float max(hi - lo, 1e-6) is.
            span = torch.clamp_min(hi.double() - lo.double(), 1e-6).float()
            gray = torch.where(covered, (nd - lo) / span, 0.0)
            fb = gray[None].expand(3, *gray.shape)
        # rgb display of a config with extra rows: the colour rows only.
        return framebuffer_to_image(fb[:3], flip_y=self.settings.flip_y)

    def screenshot(self, path: str) -> None:
        """Save the current frame (rendering one if needed) as a PNG."""
        save_png(self.draw(), path, flip_y=False)  # draw() already flipped

    # ------------------------------------------------------------------ loop
    def run_headless(self, frames: int, orbit_deg_per_frame: float = 1.0):
        """Reference main loop (``cull_sort_test.cpp:52-64``): orbit,
        render, EMA report. Returns the last frame as uint8."""
        for _ in range(frames):
            self.camera.orbit(orbit_deg_per_frame, 0.0)
            self.render()
        return self.draw()

    def serve(self, host: str = "127.0.0.1", port: int = 8800):
        """Start the browser viewer (blocking; see web_viewer.py)."""
        from gaussianrenderer_tpu_torch.web_viewer import serve_canvas

        serve_canvas(self, host=host, port=port)
