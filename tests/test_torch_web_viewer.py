"""The port's browser viewer and training monitor
(``gaussianrenderer_tpu_torch.web_viewer``) on the CPU, over real
localhost HTTP (``make_server(port=0)``), held against the JAX module:
byte-equal encoders, the same page wiring, the same /stats keys and the
same monitor status. Every request has a timeout of at most 30 s, every
server shuts down in ``finally`` and every reader thread is joined with a
timeout.
"""

import io
import json
import threading
from http.client import HTTPConnection
from urllib.error import HTTPError
from urllib.request import urlopen

import numpy as np
import pytest
from PIL import Image

from gaussianrenderer_tpu import web_viewer as jax_wv
from gaussianrenderer_tpu.scene.compact import save_compact, save_splat
from gaussianrenderer_tpu.scene.io import make_random_scene as jax_make_scene
from gaussianrenderer_tpu.scene.io import save_ply
from gaussianrenderer_tpu.viewer import Canvas as JaxCanvas

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch import web_viewer as wv
from gaussianrenderer_tpu_torch.viewer import Canvas

TIMEOUT = 30


def _get(url):
    with urlopen(url, timeout=TIMEOUT) as r:
        return r.read()


class _Serving:
    """``make_server(canvas, port=0)`` run in a thread for a ``with`` block."""

    def __init__(self, make, canvas):
        self.server = make(canvas, port=0)
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=TIMEOUT)
        assert not self.thread.is_alive()
        return False


def _canvas(h=48, w=64, n=300, seed=4, jax=False, **kw):
    if jax:
        c = JaxCanvas(height=h, width=w, compositor="xla")
        c.init(prewarm=False)
        c.set_scene(jax_make_scene(n, seed=seed, **kw))
    else:
        c = Canvas(height=h, width=w, compositor="xla", device="cpu")
        c.set_scene(gt.make_random_scene(n, seed=seed, device="cpu", **kw))
    return c


def _image(h=20, w=31, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("shape", [(20, 31), (16, 32), (1, 1)])
def test_encoders_byte_equal_to_jax(shape):
    """PNG and BMP (odd widths pad rows to 4 bytes) bytes equal the JAX
    module's; JPEG bytes are equal under the same Pillow."""
    img = _image(*shape)
    assert wv._png_encode(img) == jax_wv._png_encode(img)
    assert wv._bmp_encode(img) == jax_wv._bmp_encode(img)
    for fmt in ("auto", "jpeg", "bmp", "png"):
        assert wv._encode_frame(img, fmt) == jax_wv._encode_frame(img, fmt), fmt
    back = np.asarray(Image.open(io.BytesIO(wv._encode_frame(img, "bmp")[0])))
    np.testing.assert_array_equal(back, img)
    with pytest.raises(ValueError, match="unknown frame format"):
        wv._encode_frame(img, "gif")


def test_page_wiring():
    """The page wires the push stream, the drop target and the controls,
    as the JAX page does; element ids are unique."""
    page = wv._PAGE.encode()
    for token in (b"/stream", b"'drop'", b"/set", b"/orbit", b"/zoom", b"/load?name=",
                  b"tTouched", b"synced", b'id="vm"'):
        assert token in page and token in jax_wv._PAGE.encode(), token
    assert page.count(b'id="view"') == 1
    assert b"gaussianrenderer_tpu_torch viewer" in page
    assert wv._MONITOR_PAGE == jax_wv._MONITOR_PAGE


def test_http_endpoints():
    """Page, a PNG frame equal to draw()'s image, the default fast
    encode, orbit and set controls, /stats with the JAX module's keys, and
    a clean 400 for a malformed parameter."""
    c = _canvas(spacetime=True)
    jc = _canvas(jax=True, spacetime=True)
    with _Serving(wv.make_server, c) as s, _Serving(jax_wv.make_server, jc) as js:
        assert b"gaussianrenderer_tpu_torch viewer" in _get(s.base + "/")
        png = _get(s.base + "/frame?fmt=png")
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), c.draw())
        frame = _get(s.base + "/frame?t=1")
        assert frame[:2] == b"\xff\xd8"  # JPEG: PIL is present
        assert _get(s.base + "/frame?fmt=bmp")[:2] == b"BM"
        assert _get(s.base + "/orbit?dx=5&dy=2") == b"ok"
        assert _get(s.base + "/set?k_sigma=2.5&fov=80&flip=1&time=0.7&view=depth") == b"ok"
        assert c.settings.k_sigma == 2.5 and c.settings.time_value == 0.7
        assert c.settings.view_mode == "depth" and c.settings.fov_y == 80.0
        assert _get(s.base + "/frame?t=3")[:2] == b"\xff\xd8"
        assert c._fb.shape == (5, 48, 64)
        assert _get(s.base + "/zoom?d=0.5") == b"ok"
        assert _get(s.base + "/set?view=rgb") == b"ok"
        assert _get(s.base + "/frame?t=2") != frame  # orbit, zoom and time changed it
        stats = json.loads(_get(s.base + "/stats"))
        assert stats["gaussians"] == 300 and stats["spacetime"] is True
        assert stats["k_sigma"] == 2.5 and stats["fov_y"] == 80.0
        assert stats["flip_y"] is True and stats["view_mode"] == "rgb"
        fm = stats["frame"]
        assert fm["total_ms"] > 0 and fm["encode_ms"] >= 0
        assert fm["fmt"] == "jpeg" and fm["bytes"] > 0
        _get(js.base + "/frame")
        jstats = json.loads(_get(js.base + "/stats"))
        assert stats.keys() == jstats.keys() and fm.keys() == jstats["frame"].keys()
        with pytest.raises(HTTPError) as e:
            _get(s.base + "/orbit?dx=abc&dy=0")
        assert e.value.code == 400
        with pytest.raises(HTTPError) as e:
            _get(s.base + "/nothing")
        assert e.value.code == 404


def test_failed_render_answers_500(monkeypatch):
    """An error in the render (a kernel that fails to build or launch on
    the card) answers 500 with the error, and the server keeps serving."""
    c = _canvas()

    def fail():
        raise RuntimeError("tile_render2 kernel launch failed")

    monkeypatch.setattr(c, "render", fail)
    with _Serving(wv.make_server, c) as s:
        with pytest.raises(HTTPError) as e:
            _get(s.base + "/frame")
        assert e.value.code == 500 and b"kernel launch failed" in e.value.read()
        assert json.loads(_get(s.base + "/stats"))["gaussians"] == 300


def test_stream_yields_parts():
    """GET /stream?frames=2 yields 2 multipart parts, pushed on input."""
    c = _canvas()
    results = {}
    with _Serving(wv.make_server, c) as s:
        def reader():
            with urlopen(s.base + "/stream?frames=2", timeout=TIMEOUT) as r:
                results["ctype"] = r.headers["Content-Type"]
                results["data"] = r.read()  # the server closes after 2 parts

        rt = threading.Thread(target=reader)
        rt.start()
        # Poke until the stream closes: a poke that lands while the pusher
        # is busy is coalesced with the frame under way.
        for _ in range(12):
            _get(s.base + "/orbit?dx=8&dy=1")
            rt.join(timeout=2.5)
            if not rt.is_alive():
                break
        rt.join(timeout=TIMEOUT)
        assert not rt.is_alive(), "stream did not complete"
        assert "multipart/x-mixed-replace" in results["ctype"]
        data = results["data"]
        assert data.count(b"--grframe") == 2 and data.count(b"image/jpeg") == 2
        assert json.loads(_get(s.base + "/stats"))["frame"]["streamed"] is True


@pytest.mark.parametrize("ext", [".ply", ".gsz", ".splat"])
def test_drop_upload_hot_swaps(ext, tmp_path):
    """POST /load with .ply, .gsz and .splat bytes written by the JAX
    package swaps the scene; a bad name or a bad body answers 400 and
    leaves the scene in place."""
    path = tmp_path / f"dropped{ext}"
    {".ply": save_ply, ".gsz": save_compact, ".splat": save_splat}[ext](
        jax_make_scene(123, seed=9), str(path))
    body = path.read_bytes()
    c = _canvas()
    with _Serving(wv.make_server, c) as s:
        conn = HTTPConnection("127.0.0.1", s.server.server_address[1], timeout=TIMEOUT)
        try:
            conn.request("POST", f"/load?name=dropped{ext}", body=body,
                         headers={"Content-Length": str(len(body))})
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read()) == {"ok": True,
                                                                      "gaussians": 123}
            assert c.scene.num_gaussians == 123 and c._last_drop.endswith(f"dropped{ext}")
            assert c._last_drop.startswith(wv.UPLOAD_DIR)
            for name, data in ((".evil", b"x"), (f"bad{ext}", b"not a scene")):
                conn.request("POST", f"/load?name={name}", body=data,
                             headers={"Content-Length": str(len(data))})
                resp = conn.getresponse()
                resp.read()
                assert resp.status == 400, name
            assert c.scene.num_gaussians == 123
        finally:
            conn.close()
        assert _get(s.base + "/frame?fmt=png")[:8] == b"\x89PNG\r\n\x1a\n"


def test_train_monitor_matches_jax():
    """/frame is 404 before the first snapshot; /status equals the JAX
    monitor's for the same update, and /frame is the same PNG."""
    ours, theirs = wv.TrainMonitor(port=0).start(), jax_wv.TrainMonitor(port=0).start()
    try:
        bases = [m.url.rstrip("/") for m in (ours, theirs)]
        assert b"live training monitor" in _get(bases[0] + "/")
        with pytest.raises(HTTPError) as e:
            _get(bases[0] + "/frame")
        assert e.value.code == 404
        assert _get(bases[0] + "/status") == _get(bases[1] + "/status")
        img = _image(24, 32, seed=0)
        for m in (ours, theirs):
            m.update(150, 0.0123, img, num_gaussians=4096, total_steps=500)
        status = [json.loads(_get(b + "/status")) for b in bases]
        assert status[0] == status[1] == {"step": 150, "loss": 0.0123, "gaussians": 4096,
                                          "total_steps": 500}
        frames = [_get(b + "/frame") for b in bases]
        assert frames[0] == frames[1]
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(frames[0]))), img)
    finally:
        ours.stop()
        theirs.stop()
    assert not ours._thread.is_alive()
