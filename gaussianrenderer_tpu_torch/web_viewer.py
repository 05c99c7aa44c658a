"""Browser viewer — the display transport for Canvas (PyTorch port of
``web_viewer.py``).

The reference displays through OpenGL: a per-frame D2H copy, an SSBO
upload and a fullscreen-quad fragment shader (``canvas.cpp:344-365``).
Here the hop is framebuffer → uint8 image (converted on the card, 3 bytes
a pixel copied) → JPEG (PIL; BMP, a memcpy-class encode, without PIL;
lossless PNG behind ``?fmt=png``) → localhost HTTP: a single-page viewer
with drag-orbit, scroll-zoom and the reference's ImGui settings (flip-Y,
k-sigma, fovY) as HTML controls (``Canvas::debugWindow``,
``canvas.cpp:298-335``). The /frame stage timings (the ``render()``
call, the draw with its device wait and copy, the encode) ride /stats, so
the loop a user sees is measured end to end like the reference's EMA
line (``cull_sort_test.cpp:56-63``).

Endpoints:
  GET /          the viewer page
  GET /frame     current frame as JPEG/BMP/PNG (renders on demand)
  GET /stream    multipart/x-mixed-replace (MJPEG) push stream: frames
                 are rendered and pushed whenever input marks the view
                 dirty (?continuous=1 streams an orbit unconditionally,
                 ?frames=N closes after N parts); render(t+1) is issued
                 before frame t's draw and encode
  POST /load?name=x.ply   upload a scene file (.ply, .gsz or .splat; the
                 browser drag-drop target, reference hot swap
                 ``canvas.cpp:280-296``), stored under its name in the
                 server's private upload directory (mode 0700, made
                 for each server and removed at its shutdown; the file
                 is created anew and never through a symlink)
  GET /orbit?dx=&dy=   orbit by pixel deltas × orbit speed
  GET /zoom?d=         zoom along the view axis
  GET /set?k_sigma=&fov=&flip=&time=&view=   update UiSettings
  GET /stats     JSON render stats and the last /frame stage timings

Every use of the canvas holds one lock: the server answers each request
on its own thread, and each thread launches on its current CUDA stream
(the default stream), taken at each launch.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import sys
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from gaussianrenderer_tpu_torch.render import _png_encode

#: Prefix of each viewer server's private upload directory
#: (``tempfile.mkdtemp`` under the temp directory).
UPLOAD_PREFIX = "gr_torch_uploads_"


class _ViewerServer(ThreadingHTTPServer):
    """The viewer's HTTP server with its own upload directory: made by
    ``tempfile.mkdtemp`` (mode 0700, a new name for each server, so no
    other user can create it first or plant a file in it) and removed
    with its uploads at ``shutdown`` and ``server_close``."""

    def __init__(self, address, handler):
        super().__init__(address, handler)
        self.upload_dir = tempfile.mkdtemp(prefix=UPLOAD_PREFIX)

    def shutdown(self):
        super().shutdown()
        shutil.rmtree(self.upload_dir, ignore_errors=True)

    def server_close(self):
        super().server_close()
        shutil.rmtree(self.upload_dir, ignore_errors=True)


def _open_upload(path: str):
    """A new file at ``path`` for writing (0600): a file of that name
    from an earlier upload is unlinked first, so a re-upload replaces it,
    and the open neither follows a symlink nor reuses a file that
    appeared in between (``O_EXCL | O_NOFOLLOW``)."""
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL | os.O_NOFOLLOW, 0o600)
    return os.fdopen(fd, "wb")


def _bmp_encode(img: np.ndarray) -> bytes:
    """Uncompressed 24-bit BMP: rows bottom-up in BGR with 4-byte row
    alignment; a memcpy-class encode that browsers decode natively."""
    h, w, _ = img.shape
    row = w * 3
    pad = (-row) % 4
    body = img[::-1, :, ::-1]  # bottom-up, BGR
    if pad:
        body = np.pad(body.reshape(h, row), ((0, 0), (0, pad)))
    data = body.tobytes()
    size = 54 + len(data)
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", size, 0, 0, 54,          # file header
        40, w, h, 1, 24, 0, len(data),  # BITMAPINFOHEADER
        2835, 2835, 0, 0,
    )
    return header + data


def _encode_frame(img: np.ndarray, fmt: str = "auto"):
    """Encode a display frame; returns ``(bytes, content_type, fmt)``.

    ``auto`` prefers JPEG (PIL, quality 85) and falls back to BMP without
    PIL; PNG is the lossless form (``/frame?fmt=png``)."""
    img = np.ascontiguousarray(img)
    if fmt in ("auto", "jpeg", "jpg"):
        try:
            import io

            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=85)
            return buf.getvalue(), "image/jpeg", "jpeg"
        except ImportError:
            if fmt != "auto":
                raise ValueError("jpeg needs PIL; use fmt=bmp or png")
    if fmt in ("auto", "bmp"):
        return _bmp_encode(img), "image/bmp", "bmp"
    if fmt == "png":
        return _png_encode(img), "image/png", "png"
    raise ValueError(f"unknown frame format {fmt!r}")


_PAGE = """<!DOCTYPE html>
<html><head><title>gaussianrenderer_tpu_torch</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:16px; }
#view { border:1px solid #444; cursor:grab; max-width:100%; }
.panel { margin:8px 0; } label { margin-right:16px; }
</style></head><body>
<h3>gaussianrenderer_tpu_torch viewer</h3>
<img id="view" draggable="false"/>
<div class="panel">
  <label>k-sigma <input id="k" type="range" min="0.1" max="8" step="0.1" value="3"/>
  <span id="kv">3.0</span></label>
  <label>fovY <input id="f" type="range" min="10" max="160" step="1" value="70"/>
  <span id="fv">70</span></label>
  <label><input id="flip" type="checkbox" checked/> flip-Y</label>
  <label>view <select id="vm">
  <option value="rgb" selected>rgb</option>
  <option value="depth">depth</option></select></label>
  <label id="tw" style="display:none">time
  <input id="t" type="range" min="0" max="1" step="0.01" value="0"/>
  <span id="tv">0.00</span></label>
</div>
<div class="panel" id="stats"></div>
<script>
const img = document.getElementById('view');
// Push transport: the server streams MJPEG parts whenever input marks
// the view dirty (render/fetch pipelined server-side). Falls back to
// /frame polling if the stream dies.
let streaming = true;
function startStream() {
  img.onerror = () => { streaming = false; refresh(); };
  img.src = '/stream?t=' + Date.now();
}
let busy = false, dirty = true;
async function refresh() {
  if (streaming) {
    fetch('/stats').then(r => r.json()).then(s => {
      document.getElementById('stats').textContent = JSON.stringify(s);
    });
    return;
  }
  if (busy) { dirty = true; return; }
  busy = true; dirty = false;
  img.src = '/frame?t=' + Date.now();
  await new Promise(r => { img.onload = r; img.onerror = r; });
  fetch('/stats').then(r => r.json()).then(s => {
    document.getElementById('stats').textContent = JSON.stringify(s);
  });
  busy = false;
  if (dirty) refresh();
}
let drag = null;
img.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; });
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('mousemove', async e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  await fetch(`/orbit?dx=${dx}&dy=${dy}`);
  refresh();
});
img.addEventListener('wheel', async e => {
  e.preventDefault();
  await fetch(`/zoom?d=${e.deltaY > 0 ? -0.3 : 0.3}`);
  refresh();
});
// Drag-and-drop a .ply/.gsz/.splat anywhere on the page → hot scene
// swap (reference canvas.cpp:280-296).
window.addEventListener('dragover', e => { e.preventDefault(); });
window.addEventListener('drop', async e => {
  e.preventDefault();
  const f = e.dataTransfer.files[0];
  if (!f) return;
  const st = document.getElementById('stats');
  st.textContent = `loading ${f.name} (${f.size} bytes)…`;
  const r = await fetch('/load?name=' + encodeURIComponent(f.name), {
    method: 'POST', body: f,
  });
  st.textContent = r.ok ? `loaded ${f.name}: ` + await r.text()
                        : `load failed: ` + await r.text();
  refresh();
});
let tTouched = false;  // never send time until the user scrubs it — a
                       // 4D scene renders STATIC until the slider moves
let synced = false;    // controls start from SERVER state, not the HTML
                       // defaults — sending before sync would silently
                       // override e.g. the session's fovY with the
                       // slider's hardcoded initial value
async function setParams() {
  if (!synced) return;
  const k = document.getElementById('k').value;
  const f = document.getElementById('f').value;
  const flip = document.getElementById('flip').checked ? 1 : 0;
  const t = document.getElementById('t').value;
  const view = document.getElementById('vm').value;
  document.getElementById('kv').textContent = k;
  document.getElementById('fv').textContent = f;
  document.getElementById('tv').textContent = Number(t).toFixed(2);
  let url = `/set?k_sigma=${k}&fov=${f}&flip=${flip}&view=${view}`;
  if (tTouched) url += `&time=${t}`;
  await fetch(url);
  refresh();
}
for (const id of ['k', 'f', 'flip', 't', 'vm'])
  document.getElementById(id).addEventListener('input', e => {
    if (e.target.id === 't') tTouched = true;
    setParams();
  });
fetch('/stats').then(r => r.json()).then(s => {
  if (s.spacetime) document.getElementById('tw').style.display = '';
  document.getElementById('k').value = s.k_sigma;
  document.getElementById('kv').textContent = s.k_sigma;
  document.getElementById('f').value = s.fov_y;
  document.getElementById('fv').textContent = s.fov_y;
  document.getElementById('flip').checked = !!s.flip_y;
  document.getElementById('vm').value = s.view_mode || 'rgb';
  synced = true;
});
startStream();
refresh();
</script></body></html>"""


def make_server(canvas, host: str = "127.0.0.1", port: int = 8800):
    """Build the viewer's ThreadingHTTPServer without starting it — the
    testable core of :func:`serve_canvas` (drive with ``serve_forever`` /
    ``shutdown``; ``port=0`` picks a free port). Uploads go to the
    server's ``upload_dir``, which ``shutdown`` removes."""
    lock = threading.Lock()
    #: Last /frame stage timings (ms), surfaced via /stats: the
    #: ``render()`` call (dispatch_ms), the draw with its device wait and
    #: copy (fetch_draw_ms), the encode, the total, and the wire bytes.
    frame_ms = {}
    #: Input → stream signalling: every input endpoint marks the view
    #: dirty and wakes the /stream pushers.
    cond = threading.Condition()
    state = {"gen": 0}

    def mark_dirty():
        with cond:
            state["gen"] += 1
            cond.notify_all()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_POST(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            try:
                if url.path == "/load":
                    name = os.path.basename(q.get("name", "drop.ply"))
                    if not name or name.startswith("."):
                        raise ValueError("bad scene file name")
                    length = int(self.headers.get("Content-Length", "0"))
                    if length <= 0 or length > 8 << 30:
                        raise ValueError("missing or oversized upload body")
                    path = os.path.join(self.server.upload_dir, name)
                    with _open_upload(path) as fh:
                        remaining = length
                        while remaining:
                            chunk = self.rfile.read(min(remaining, 1 << 20))
                            if not chunk:
                                raise ValueError("truncated upload")
                            fh.write(chunk)
                            remaining -= len(chunk)
                    with lock:
                        canvas.drop_file(path)
                        n = canvas.scene.num_gaussians
                    mark_dirty()
                    self._send(
                        200,
                        "application/json",
                        json.dumps({"ok": True, "gaussians": int(n)}).encode(),
                    )
                else:
                    self._send(404, "text/plain", b"not found")
            except (BrokenPipeError, ConnectionResetError):
                pass
            except Exception as e:  # surface load errors to the page
                try:
                    self._send(400, "text/plain", str(e).encode())
                except OSError:
                    pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def _stream(self, q):
            """MJPEG push loop (multipart/x-mixed-replace).

            Frame t+1's ``render()`` is issued before frame t's draw,
            encode and write, so the card works on the next frame while
            the previous one is copied, encoded and sent. Frames are
            pushed only when input marked the view dirty (?continuous=1
            renders an orbit unconditionally; ?frames=N closes after N
            parts)."""
            continuous = q.get("continuous") == "1"
            max_frames = int(q.get("frames", "0") or 0)
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "multipart/x-mixed-replace; boundary=grframe",
            )
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            pending = None
            last_gen = -1
            sent = 0
            while True:
                with cond:
                    fresh = state["gen"] != last_gen
                if continuous or fresh or pending is None:
                    with lock:
                        last_gen = state["gen"]
                        t0 = time.perf_counter()
                        canvas.render()
                        frame_ms["dispatch_ms"] = round(
                            (time.perf_counter() - t0) * 1e3, 2
                        )
                        new_fb = canvas._fb
                else:
                    new_fb = None
                if pending is not None:
                    t1 = time.perf_counter()
                    with lock:
                        img = canvas.draw(fb=pending)
                    t2 = time.perf_counter()
                    body, ctype, used = _encode_frame(
                        img, q.get("fmt", "auto")
                    )
                    t3 = time.perf_counter()
                    frame_ms.update(
                        fetch_draw_ms=round((t2 - t1) * 1e3, 2),
                        encode_ms=round((t3 - t2) * 1e3, 2),
                        fmt=used,
                        bytes=len(body),
                        streamed=True,
                    )
                    part = (
                        b"--grframe\r\nContent-Type: "
                        + ctype.encode()
                        + b"\r\nContent-Length: "
                        + str(len(body)).encode()
                        + b"\r\n\r\n"
                        + body
                        + b"\r\n"
                    )
                    self.wfile.write(part)
                    self.wfile.flush()
                    sent += 1
                    if max_frames and sent >= max_frames:
                        return
                pending = new_fb
                if pending is None and not continuous:
                    with cond:
                        if state["gen"] == last_gen:
                            cond.wait(timeout=30.0)

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            try:
                if url.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif url.path == "/frame":
                    with lock:
                        t0 = time.perf_counter()
                        canvas.render()
                        t1 = time.perf_counter()
                        img = canvas.draw()
                        t2 = time.perf_counter()
                    body, ctype, used = _encode_frame(
                        img, q.get("fmt", "auto")
                    )
                    t3 = time.perf_counter()
                    frame_ms.update(
                        dispatch_ms=round((t1 - t0) * 1e3, 2),
                        fetch_draw_ms=round((t2 - t1) * 1e3, 2),
                        encode_ms=round((t3 - t2) * 1e3, 2),
                        total_ms=round((t3 - t0) * 1e3, 2),
                        fmt=used,
                        bytes=len(body),
                    )
                    self._send(200, ctype, body)
                elif url.path == "/stream":
                    self._stream(q)
                elif url.path == "/orbit":
                    with lock:
                        dx = float(q.get("dx", 0.0))
                        dy = float(q.get("dy", 0.0))
                        canvas.camera.orbit(
                            dx * canvas.controls.orbit_speed_x,
                            dy * canvas.controls.orbit_speed_y,
                        )
                    mark_dirty()
                    self._send(200, "text/plain", b"ok")
                elif url.path == "/zoom":
                    with lock:
                        canvas.camera.zoom(float(q.get("d", 0.0)))
                    mark_dirty()
                    self._send(200, "text/plain", b"ok")
                elif url.path == "/set":
                    with lock:
                        if "k_sigma" in q:
                            canvas.settings.k_sigma = float(q["k_sigma"])
                        if "fov" in q:
                            canvas.set_fov(float(q["fov"]))
                        if "flip" in q:
                            canvas.settings.flip_y = q["flip"] == "1"
                        if "time" in q:
                            canvas.settings.time_value = float(q["time"])
                        if "view" in q:
                            canvas.settings.view_mode = q["view"]
                        canvas.settings.clamp()
                    mark_dirty()
                    self._send(200, "text/plain", b"ok")
                elif url.path == "/stats":
                    with lock:
                        ema = canvas.timer.ema_ms
                        body = json.dumps(
                            {
                                "frames": canvas.timer.frames,
                                "ema_ms": None if ema is None else round(ema, 3),
                                "fps": None if not ema else round(1000.0 / ema, 1),
                                "gaussians": (
                                    canvas.scene.num_gaussians
                                    if canvas.scene is not None
                                    else 0
                                ),
                                "spacetime": bool(
                                    canvas.scene is not None
                                    and canvas.scene.time_params is not None
                                ),
                                # Current settings: the page initializes
                                # its controls from these on load.
                                "k_sigma": canvas.settings.k_sigma,
                                "fov_y": canvas.settings.fov_y,
                                "flip_y": canvas.settings.flip_y,
                                "view_mode": canvas.settings.view_mode,
                                "frame": dict(frame_ms),
                            }
                        ).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")
            except (BrokenPipeError, ConnectionResetError):
                # The page replaces img.src mid-load while dragging:
                # aborted /frame requests are routine.
                pass
            except ValueError as e:
                try:
                    self._send(400, "text/plain", str(e).encode())
                except OSError:
                    pass
            except Exception as e:
                # A failed kernel build or launch: the request answers 500
                # with the error (the traceback goes to stderr), and the
                # server keeps serving.
                traceback.print_exc(file=sys.stderr)
                try:
                    self._send(500, "text/plain", f"{type(e).__name__}: {e}".encode())
                except OSError:
                    pass

    return _ViewerServer((host, port), Handler)


def serve_canvas(canvas, host: str = "127.0.0.1", port: int = 8800) -> None:
    """Blocking HTTP viewer for a :class:`gaussianrenderer_tpu_torch.viewer.Canvas`."""
    server = make_server(canvas, host, port)
    print(f"viewer: http://{host}:{server.server_address[1]}/", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


_MONITOR_PAGE = """<!DOCTYPE html>
<html><head><title>gr-fit monitor</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:16px; }
#view { border:1px solid #444; max-width:100%; }
.panel { margin:8px 0; }
</style></head><body>
<h3>gr-fit live training monitor</h3>
<img id="view"/>
<div class="panel" id="status">waiting for the first snapshot…</div>
<script>
const img = document.getElementById('view');
async function poll() {
  try {
    const s = await (await fetch('/status')).json();
    document.getElementById('status').textContent = JSON.stringify(s);
    if (s.step) {
      img.src = '/frame?t=' + s.step;
      await new Promise(r => { img.onload = r; img.onerror = r; });
    }
  } catch (e) {}
  setTimeout(poll, 1500);
}
poll();
</script></body></html>"""


class TrainMonitor:
    """Live browser monitor for a running fit (the remote training viewer
    of the 3DGS ecosystem).

    The trainer publishes with :meth:`update` (wired to ``fit_scene``'s
    ``snapshot_fn``); browsers poll ``/`` (the page), ``/frame`` (the
    latest snapshot as PNG, 404 before the first) and ``/status`` (JSON:
    step, loss, gaussians, total steps). Thread-safe; serving starts on
    :meth:`start` and never blocks the training loop.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8810):
        self._lock = threading.Lock()
        self._png = None
        self._status = {"step": 0, "loss": None, "gaussians": 0,
                        "total_steps": None}
        monitor = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                try:
                    if path == "/":
                        self._send(200, "text/html", _MONITOR_PAGE.encode())
                    elif path == "/frame":
                        with monitor._lock:
                            png = monitor._png
                        if png is None:
                            self._send(404, "text/plain", b"no snapshot yet")
                        else:
                            self._send(200, "image/png", png)
                    elif path == "/status":
                        with monitor._lock:
                            body = json.dumps(monitor._status).encode()
                        self._send(200, "application/json", body)
                    else:
                        self._send(404, "text/plain", b"not found")
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self.server = ThreadingHTTPServer((host, port), Handler)
        self._thread = None

    @property
    def url(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}/"

    def start(self):
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def update(self, step: int, loss, image: np.ndarray,
               num_gaussians: int = 0, total_steps=None):
        """Publish a snapshot: ``image`` is (H, W, 3) uint8."""
        png = _png_encode(np.ascontiguousarray(image))
        with self._lock:
            self._png = png
            self._status = {
                "step": int(step),
                "loss": None if loss is None else float(loss),
                "gaussians": int(num_gaussians),
                "total_steps": total_steps,
            }

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
