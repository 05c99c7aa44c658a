"""The port's apps (``gaussianrenderer_tpu_torch/apps``) and utilities
(``utils``), driven through ``main()`` on the CPU at the sizes
``tests/test_apps.py`` gives the JAX apps, and checked as it checks them;
where both apps print the same thing (the camera's matrices, the parsed
count), against the JAX app's own output, and the training apps' lines
against the JAX apps' formats.
"""

import io
import json
import os
import re
import sys
import types

import pytest
import torch

from gaussianrenderer_tpu.apps import camera_test as jax_camera_test
from gaussianrenderer_tpu.apps import parser_test as jax_parser_test
from gaussianrenderer_tpu.scene.io import make_random_scene, save_ply
from gaussianrenderer_tpu.utils import timing as jax_timing

from gaussianrenderer_tpu_torch.apps import edit as edit_app
from gaussianrenderer_tpu_torch.apps import eval as eval_app
from gaussianrenderer_tpu_torch.apps import (
    camera_test,
    cull_sort_test,
    fit,
    matrix_test,
    onesweep,
    parser_test,
    radix_test,
    train_test,
    window_test,
)
from gaussianrenderer_tpu_torch.utils import timing

from test_torch_common import one_torch_thread  # noqa: F401

# The fit, eval and train_test cases run the plain compositors.
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def ply_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("apps") / "scene.ply")
    save_ply(make_random_scene(2000, seed=0), path)
    return path


def _run(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    return mod.main()


def test_parser_test(ply_file, monkeypatch, capsys):
    assert _run(jax_parser_test, [ply_file], monkeypatch) == 0
    want = capsys.readouterr().out
    assert _run(parser_test, [ply_file, "--device", "cpu"], monkeypatch) == 0
    got = capsys.readouterr().out
    assert "2000 gaussians" in got
    assert got == want
    assert _run(parser_test, [], monkeypatch) == 2


def test_camera_test_matches_jax(monkeypatch, capsys):
    assert jax_camera_test.main() == 0
    want = capsys.readouterr().out
    assert _run(camera_test, ["--device", "cpu"], monkeypatch) == 0
    got = capsys.readouterr().out
    assert "proj" in got
    assert got == want


def test_onesweep_harness(monkeypatch, capsys):
    rc = _run(
        onesweep,
        ["--minN", "100", "--maxN", "5000", "--growth", "3.0", "--device", "cpu"],
        monkeypatch,
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "PASS" in out and "0 failed" in out
    rc = _run(onesweep, ["--minN", "1000", "--maxN", "1010", "--mode", "consecutive",
                         "--device", "cpu"], monkeypatch)
    assert rc == 0
    assert "10 passed, 0 failed" in capsys.readouterr().out


@pytest.mark.parametrize("ones", [True, False])
def test_matrix_test_small(ones, monkeypatch, capsys):
    rc = _run(
        matrix_test,
        ["--n", "512", "--bm", "256", "--bn", "256", "--bk", "256",
         "--iters", "1", "--device", "cpu"] + (["--ones"] if ones else []),
        monkeypatch,
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "OK" in out
    assert "matmul_blocked:" in out and "torch_mm:" in out


def test_matrix_test_rejects_non_multiples(monkeypatch):
    with pytest.raises(ValueError, match="block multiples"):
        _run(matrix_test, ["--n", "384", "--bm", "256", "--iters", "1", "--device", "cpu"],
             monkeypatch)


def test_radix_test_bench(monkeypatch, capsys, tmp_path):
    out = tmp_path / "radix_bench.jsonl"
    rc = _run(
        radix_test,
        ["--minN", "512", "--maxN", "2048", "--growth", "4.0", "--iters", "1",
         "--out", str(out), "--device", "cpu"],
        monkeypatch,
    )
    assert rc == 0
    assert "PASS" in capsys.readouterr().err
    lines = [json.loads(l) for l in out.read_text().splitlines()]
    assert len(lines) == 6  # N = 512, 2048 x three algorithms
    assert all(
        rec["nondecreasing"] and rec["matches_oracle"] and rec["radix_matches"]
        for rec in lines
    )
    for rec in lines:
        assert rec["torch"] == torch.__version__ and "jax" not in rec
        assert rec["platform"] == "cpu" and rec["device_ms"] >= 0


def test_radix_test_default_out_is_under_build(monkeypatch, tmp_path):
    """Without ``--out`` the records go to build/radix_bench_port.jsonl, never
    to radix_bench.jsonl, the JAX package's TPU record at the repo root."""
    monkeypatch.chdir(tmp_path)
    rc = _run(radix_test, ["--minN", "512", "--maxN", "512", "--iters", "1",
                           "--device", "cpu"], monkeypatch)
    assert rc == 0
    assert not (tmp_path / "radix_bench.jsonl").exists()
    recs = (tmp_path / "build" / "radix_bench_port.jsonl").read_text().splitlines()
    assert len(recs) == 3


_APPS = {
    "parser_test": (parser_test, [os.path.join(os.path.dirname(__file__), "fixtures",
                                               "trained.ply")]),
    "camera_test": (camera_test, []),
    "onesweep": (onesweep, ["--minN", "100", "--maxN", "200"]),
    "matrix_test": (matrix_test, ["--n", "256", "--bm", "256", "--bn", "256", "--bk", "256"]),
    "radix_test": (radix_test, ["--minN", "512", "--maxN", "512", "--out", ""]),
    "train_test": (train_test, ["--steps", "2"]),
    "fit": (fit, ["no-such-dataset", "--steps", "2"]),
    "eval": (eval_app, ["no-such-scene.ply", "no-such-dataset"]),
    "edit": (edit_app, ["out.ply", "no-such-scene.ply"]),
    "cull_sort_test": (cull_sort_test, ["--synthetic", "10", "--frames", "1"]),
    "window_test": (window_test, ["--n", "10"]),
}


@pytest.mark.parametrize("name", sorted(_APPS))
def test_apps_raise_for_cuda_without_a_card(name, monkeypatch):
    """``--device`` defaults to cuda; without a card every app raises
    rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the apps run there")
    mod, argv = _APPS[name]
    with pytest.raises(RuntimeError, match="cuda"):
        _run(mod, argv, monkeypatch)


# The JAX apps' line formats (gaussianrenderer_tpu/apps/train_test.py, fit.py).
TRAIN_TEST_LINES = (r"step \d+: densify recycled=\d+ dead=\d+",
                    r"loss: \d+\.\d{5} -> \d+\.\d{5} \(\d+ steps, \d+ poses\)",
                    r"final PSNR vs target pose 0: \d+\.\d{2} dB")
FIT_LINES = (r"\d+ train / \d+ held-out views at \d+x\d+",
             r"SfM init: \d+ points -> \d+ splats",
             r"step \d+: loss \d+\.\d{5}",
             r"final: PSNR \d+\.\d{2} dB  SSIM \d\.\d{4}",
             r"held-out: PSNR \d+\.\d{2} dB  SSIM \d\.\d{4}",
             r"wrote \S+",
             r"loss: first-epoch mean \d+\.\d{5} -> last-epoch mean \d+\.\d{5}")


def _lines_match(out, formats):
    lines = out.strip().splitlines()
    for line in lines:
        assert any(re.fullmatch(f, line) for f in formats), line
    return lines


def test_train_test_demo(monkeypatch, capsys):
    rc = _run(train_test, ["--n", "120", "--steps", "12", "--densify-every", "6",
                           "--poses", "2", "--device", "cpu"], monkeypatch)
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = _lines_match(out, TRAIN_TEST_LINES)
    assert [l.split(":")[0] for l in lines[:2]] == ["step 6", "step 12"]
    assert "(12 steps, 2 poses)" in lines[2]


@pytest.fixture(scope="module")
def poses_dataset(tmp_path_factory):
    """tests/test_apps.py's gr-fit dataset: 2 views at 64×48 of a seeded
    scene, rendered by the port, as .npy targets."""
    import numpy as np

    import gaussianrenderer_tpu_torch as gt

    root = tmp_path_factory.mktemp("fit")
    cfg = gt.RenderConfig(height=48, width=64)
    truth = gt.SceneParams.from_scene(gt.make_random_scene(
        150, seed=9, scale_range=(0.05, 0.2), device="cpu"))
    records = []
    for i in range(2):
        c = gt.Camera()
        c.set_position([0.4 * i, 0.0, 5.0])
        c.set_look_at([0.0, 0.0, 0.0])
        c.set_fov_y(60.0)
        c.set_aspect_ratio(64 / 48)
        c.set_clipping_planes(0.2, 100.0)
        c.update_camera_matrices()
        with torch.no_grad():
            fb = gt.render_for_training(truth, c.params(cfg.k_sigma, device="cpu"), cfg)
        np.save(root / f"t{i}.npy", fb.numpy().transpose(1, 2, 0)[::-1])
        m = np.zeros((3, 4), np.float32)
        m[:, 0], m[:, 1], m[:, 2] = c.r_axis, -c.u_axis, -c.f_axis
        m[:, 3] = c.position
        records.append({"c2w": m.tolist(), "fov_y": 60.0, "near": 0.2,
                        "far": 100.0, "target": f"t{i}.npy"})
    (root / "poses.json").write_text(json.dumps(records))
    return root


def test_fit_app(poses_dataset, tmp_path, monkeypatch, capsys):
    """gr-fit on the CPU: a random-init fit with held-out views and
    checkpoints writes a degree-1 PLY of the budget; a refinement of that
    PLY resumes from a checkpoint."""
    import gaussianrenderer_tpu_torch as gt

    out, ck = str(tmp_path / "fitted.ply"), str(tmp_path / "ck")
    base = [str(poses_dataset), "--n", "64", "--loss", "mse", "--densify-every", "2",
            "--opacity-reset-every", "3", "--holdout-every", "2", "--sh-degree", "1",
            "--device", "cpu"]
    rc = _run(fit, base + ["--steps", "4", "--checkpoint-dir", ck,
                           "--checkpoint-every", "2", "--out", out], monkeypatch)
    text = capsys.readouterr().out
    assert rc == 0, text
    lines = _lines_match(text, FIT_LINES)
    assert lines[0] == "1 train / 1 held-out views at 64x48"
    assert sorted(os.listdir(ck)) == ["step_000002", "step_000004"]
    fitted = gt.load_ply(out, max_sh_degree=None, device="cpu")
    assert fitted.num_gaussians == 64 and fitted.sh.shape[1] == 12
    out2 = str(tmp_path / "refined.ply")
    rc = _run(fit, base + ["--steps", "4", "--init", out, "--resume",
                           os.path.join(ck, "step_000002"), "--out", out2], monkeypatch)
    text = capsys.readouterr().out
    assert rc == 0, text
    _lines_match(text, FIT_LINES)
    assert gt.load_ply(out2, device="cpu").num_gaussians == 64


@pytest.mark.parametrize("argv,item", [(["--init", "sfm"], "item 3"),
                                       (["--init", "scene.gsz"], "item 3")])
def test_fit_app_unported_options_raise(argv, item, poses_dataset, monkeypatch):
    """The item-3 options are ported and fail, as in the JAX app, only for
    what is not on disk: a poses.json dataset has no SfM points, and there
    is no scene.gsz."""
    with pytest.raises(FileNotFoundError):
        _run(fit, [str(poses_dataset), "--device", "cpu"] + argv, monkeypatch)


def test_fit_app_serve_monitor(poses_dataset, tmp_path, monkeypatch, capsys):
    """gr-fit --serve: a thread polls the training monitor's /status and
    /frame while a 12-step fit runs (a snapshot every 6 steps and one
    after the fit); it ends at step 12 of 12 with a PNG of the dataset's
    64×48."""
    import threading
    from urllib.error import HTTPError, URLError
    from urllib.request import urlopen

    import numpy as np
    from PIL import Image

    from gaussianrenderer_tpu_torch import web_viewer

    monitors = []

    class Recorded(web_viewer.TrainMonitor):
        def start(self):
            monitors.append(self)
            return super().start()

    monkeypatch.setattr(web_viewer, "TrainMonitor", Recorded)
    seen, done = [], threading.Event()

    def poll():
        while not done.is_set():
            if monitors:
                try:
                    with urlopen(monitors[0].url + "status", timeout=30) as r:
                        seen.append(json.loads(r.read())["step"])
                except (HTTPError, URLError):
                    pass
            done.wait(0.05)

    poller = threading.Thread(target=poll)
    poller.start()
    try:
        rc = _run(fit, [str(poses_dataset), "--n", "64", "--steps", "12", "--loss", "mse",
                        "--densify-every", "0", "--opacity-reset-every", "0",
                        "--serve", "0", "--serve-every", "6", "--sh-degree", "1",
                        "--out", str(tmp_path / "fitted.ply"), "--device", "cpu"], monkeypatch)
        done.set()
        poller.join(timeout=30)
        assert not poller.is_alive()
        text = capsys.readouterr().out
        assert rc == 0, text
        lines = _lines_match(text, FIT_LINES + (r"monitor: http://127\.0\.0\.1:\d+/",))
        assert lines[1] == f"monitor: {monitors[0].url}"
        base = monitors[0].url
        with urlopen(base + "status", timeout=30) as r:
            status = json.loads(r.read())
        assert status["step"] == 12 and status["total_steps"] == 12
        assert status["gaussians"] == 64 and np.isfinite(status["loss"])
        with urlopen(base + "frame", timeout=30) as r:
            img = np.asarray(Image.open(io.BytesIO(r.read())))
        assert img.shape == (48, 64, 3)
        assert seen and seen == sorted(seen) and set(seen) <= {0, 6, 12}
    finally:
        done.set()
        poller.join(timeout=30)
        for m in monitors:
            m.stop()


def _cull_sort_argv(tmp_path, tag):
    return ["--synthetic", "500", "--frames", "3", "--width", "128", "--height", "96",
            "--screenshot", str(tmp_path / f"{tag}.png")]


def test_cull_sort_test_headless(tmp_path, monkeypatch, capsys):
    """gr-render headless on the CPU prints the JAX app's lines (the EMA
    line only every 60 frames, so none at 3), and the JAX app runs the
    same session (its Pallas compositor in interpret mode) to a
    screenshot within 1 level of the port's."""
    import numpy as np
    from PIL import Image

    rc = _run(cull_sort_test, _cull_sort_argv(tmp_path, "port") + ["--device", "cpu"],
              monkeypatch)
    out = capsys.readouterr().out
    assert rc == 0, out
    formats = (r"wrote \S+/(port|jax)\.png", r"final: \d+\.\d{3} ms/frame \(\d+\.\d FPS\)")
    lines = _lines_match(out, formats)
    assert len(lines) == 2 and lines[0] == f"wrote {tmp_path / 'port.png'}"
    port_img = np.asarray(Image.open(tmp_path / "port.png"))
    assert port_img.shape == (96, 128, 3) and port_img.max() > 0
    from gaussianrenderer_tpu.apps import cull_sort_test as jax_cull_sort_test

    assert _run(jax_cull_sort_test, _cull_sort_argv(tmp_path, "jax"), monkeypatch) == 0
    want = _lines_match(capsys.readouterr().out, formats)
    assert [re.sub(r"[\d.]+", "N", l.replace("jax", "port")) for l in want] == \
        [re.sub(r"[\d.]+", "N", l) for l in lines]
    jax_img = np.asarray(Image.open(tmp_path / "jax.png"))
    assert np.abs(port_img.astype(int) - jax_img.astype(int)).max() <= 1


def test_cull_sort_test_needs_a_scene(monkeypatch, capsys):
    assert _run(cull_sort_test, ["--device", "cpu"], monkeypatch) == 2
    assert "need a PLY path or --synthetic N" in capsys.readouterr().err


def _capture_serve(monkeypatch, canvas_cls):
    served = []
    monkeypatch.setattr(canvas_cls, "serve",
                        lambda self, host="127.0.0.1", port=8800: served.append((self, port)))
    return served


def test_serve_apps_set_up_like_jax(monkeypatch):
    """window_test and gr-render --serve, with Canvas.serve replaced:
    the port's canvas holds the JAX app's scene, camera, size, settings
    and port."""
    import numpy as np

    from gaussianrenderer_tpu.apps import cull_sort_test as jax_cull_sort_test
    from gaussianrenderer_tpu.apps import window_test as jax_window_test
    from gaussianrenderer_tpu.viewer import Canvas as JaxCanvas

    from gaussianrenderer_tpu_torch.viewer import Canvas

    jax_served = _capture_serve(monkeypatch, JaxCanvas)
    served = _capture_serve(monkeypatch, Canvas)
    cases = ((window_test, jax_window_test, ["--n", "300", "--size", "64", "--port", "0"]),
             (cull_sort_test, jax_cull_sort_test,
              ["--synthetic", "200", "--width", "80", "--height", "60", "--serve",
               "--port", "9123"]))
    for mod, jax_mod, argv in cases:
        assert _run(mod, argv + ["--device", "cpu"], monkeypatch) == 0
        assert _run(jax_mod, argv, monkeypatch) == 0
        (c, port), (jc, jport) = served.pop(), jax_served.pop()
        assert port == jport == int(argv[-1])
        assert c.cfg.height == jc.cfg.height and c.cfg.width == jc.cfg.width
        assert c.device.type == "cpu" and c._prewarm_thread is not None
        for name in ("position", "look_at", "w_up", "view", "proj", "plane_normals"):
            np.testing.assert_array_equal(getattr(c.camera, name), getattr(jc.camera, name))
        assert (c.camera.near, c.camera.far, c.camera.fov_y) == (jc.camera.near, jc.camera.far,
                                                                 jc.camera.fov_y)
        assert c.settings.fov_y == jc.settings.fov_y
        assert c.scene.num_gaussians == jc.scene.num_gaussians
        for a, b in zip(c.scene, jc.scene):
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fit_app_needs_poses_json(tmp_path, monkeypatch):
    """A directory with no poses.json, COLMAP reconstruction or transforms
    file raises FileNotFoundError for poses.json, as the JAX app does."""
    with pytest.raises(FileNotFoundError, match="poses.json"):
        _run(fit, [str(tmp_path), "--device", "cpu"], monkeypatch)


# --------------------------------------------------- fit on captures, eval, edit
@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """A COLMAP workspace (tests/test_colmap.py's writer: 3 views at 64×48
    and 3 SfM points) and a Blender dataset (2 RGBA views at 64×48, the
    top rows transparent)."""
    import numpy as np
    from PIL import Image

    from test_blender import _c2w_opengl
    from test_colmap import _rotmat, write_colmap_workspace

    root = tmp_path_factory.mktemp("captures")
    poses = [(_rotmat([0.2, 1.0, 0.1 * i], 0.4 * i + 0.1), np.array([0.1 * i, -0.2, 3.0 + i]))
             for i in range(3)]
    write_colmap_workspace(str(root / "colmap"), poses,
                           points=np.array([[0.0, 0.0, 0.0], [1.0, 2.0, -1.0], [-2.0, 0.5, 1.0]]),
                           colors=np.array([[255, 0, 0], [0, 128, 0], [10, 20, 250]], np.uint8))
    blender = root / "blender"
    blender.mkdir()
    rng = np.random.default_rng(0)
    frames = []
    for i in range(2):
        img = rng.integers(0, 256, (48, 64, 4)).astype(np.uint8)
        img[..., 3] = 255
        img[:6, :, 3] = 0
        Image.fromarray(img).save(blender / f"r_{i}.png")
        frames.append({"file_path": f"r_{i}",
                       "transform_matrix": _c2w_opengl((0.5 * i, 0, 5), (0, 0, 0))})
    (blender / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 1.1, "frames": frames}))
    return {"colmap": str(root / "colmap"), "blender": str(blender)}


@pytest.mark.parametrize("kind", ["colmap", "blender"])
def test_fit_app_on_captures(kind, captures, tmp_path, monkeypatch, capsys):
    """apps/fit on a COLMAP workspace (SfM init by default: its line, 16
    splats from 3 points) and on a Blender dataset at -r 2 over white."""
    import gaussianrenderer_tpu_torch as gt

    out = str(tmp_path / "fitted.ply")
    argv = [captures[kind], "--n", "16", "--steps", "2", "--sh-degree", "1",
            "--densify-every", "0", "--out", out, "--device", "cpu"]
    if kind == "blender":
        argv += ["-r", "2", "--background", "white"]
    rc = _run(fit, argv, monkeypatch)
    text = capsys.readouterr().out
    assert rc == 0, text
    lines = _lines_match(text, FIT_LINES)
    if kind == "colmap":
        assert lines[:2] == ["3 train / 0 held-out views at 64x48", "SfM init: 3 points -> 16 splats"]
    else:
        assert lines[0] == "2 train / 0 held-out views at 32x24"
    fitted = gt.load_ply(out, max_sh_degree=None, device="cpu")
    assert fitted.num_gaussians == 16 and fitted.sh.shape[1] == 12


@pytest.mark.parametrize("ext", [".gsz", ".splat"])
def test_fit_app_init_from_compact_scenes(ext, poses_dataset, tmp_path, monkeypatch, capsys):
    """--init of a .gsz (degree 0, zero-padded up to the trained degree 1)
    and of a .splat (degree 2 as loaded, truncated to 1)."""
    import gaussianrenderer_tpu_torch as gt

    scene = gt.make_random_scene(40, seed=3, sh_degree=0, device="cpu")
    init = str(tmp_path / f"init{ext}")
    (gt.save_compact if ext == ".gsz" else gt.save_splat)(scene, init)
    out = str(tmp_path / "fitted.ply")
    rc = _run(fit, [str(poses_dataset), "--init", init, "--steps", "2", "--sh-degree", "1",
                    "--densify-every", "0", "--out", out, "--device", "cpu"], monkeypatch)
    text = capsys.readouterr().out
    assert rc == 0, text
    _lines_match(text, FIT_LINES)
    fitted = gt.load_ply(out, max_sh_degree=None, device="cpu")
    assert fitted.num_gaussians == 40 and fitted.sh.shape[1] == 12


@pytest.fixture(scope="module")
def eval_case(tmp_path_factory):
    """tests/test_apps.py's eval setup at 64×64: 2 views of a seeded scene
    rendered by the JAX package (.npy targets), and a perturbed copy of
    the scene saved as .gsz, so the scores sit far from the MSE floor."""
    import jax.numpy as jnp
    import numpy as np

    from gaussianrenderer_tpu.config import RenderConfig
    from gaussianrenderer_tpu.scene.camera import Camera
    from gaussianrenderer_tpu.scene.compact import save_compact
    from gaussianrenderer_tpu.train import SceneParams, render_for_training

    root = tmp_path_factory.mktemp("eval")
    cfg = RenderConfig(height=64, width=64)
    truth = make_random_scene(120, seed=4, scale_range=(0.05, 0.2))
    params = SceneParams.from_scene(truth)
    records = []
    for i in range(2):
        c = Camera()
        c.set_position([0.5 * i, 0.0, 5.0])
        c.set_look_at([0.0, 0.0, 0.0])
        c.set_fov_y(60.0)
        c.set_aspect_ratio(1.0)
        c.set_clipping_planes(0.2, 100.0)
        c.update_camera_matrices()
        fb = render_for_training(params, c.params(cfg.k_sigma), cfg)
        np.save(root / f"t{i}.npy", np.asarray(fb).transpose(1, 2, 0)[::-1])
        m = np.zeros((3, 4), np.float32)
        m[:, 0], m[:, 1], m[:, 2] = c.r_axis, -c.u_axis, -c.f_axis
        m[:, 3] = c.position
        records.append({"c2w": m.tolist(), "fov_y": 60.0, "near": 0.2, "far": 100.0,
                        "target": f"t{i}.npy"})
    (root / "poses.json").write_text(json.dumps(records))
    noise = np.random.default_rng(1).normal(0, 0.3, np.asarray(truth.sh).shape)
    scene = str(root / "perturbed.gsz")
    save_compact(truth._replace(sh=truth.sh + jnp.asarray(noise, jnp.float32)), scene)
    return str(root), scene


EVAL_LINES = (r"\d+ views at \d+x\d+, SH degree \d, \d+ gaussians",
              r"view +\d+: PSNR +\d+\.\d{2} dB  SSIM \d\.\d{4}",
              r"mean: PSNR \d+\.\d{2} dB  SSIM \d\.\d{4}",
              r"\{.*\}")


@pytest.mark.parametrize("path", ["train", "packed"])
def test_eval_app_matches_jax(path, eval_case, tmp_path, monkeypatch, capsys):
    """apps/eval against the JAX app on the same files: the same lines,
    the JSON report's PSNR within 0.01 dB and SSIM within 1e-4, equal
    counts and ``overflow_views`` 0 on the packed path; equal gt PNGs.
    The packed case scores one view (--holdout-every 2): the JAX side runs
    its Pallas compositor in interpret mode."""
    from gaussianrenderer_tpu.apps import eval as jax_eval

    dataset, scene = eval_case
    argv = [scene, dataset, "--path", path] + (["--holdout-every", "2"] if path == "packed"
                                               else [])
    assert _run(jax_eval, argv + ["--out-dir", str(tmp_path / "jax")], monkeypatch) == 0
    want = capsys.readouterr().out.strip().splitlines()
    assert _run(eval_app, argv + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"],
                monkeypatch) == 0
    got = _lines_match(capsys.readouterr().out, EVAL_LINES)
    assert len(got) == len(want) == 4 + (path == "train")
    assert got[0] == want[0] == f"{2 - (path == 'packed')} views at 64x64, SH degree 2, " \
        "120 gaussians"
    jrep, prep = json.loads(want[-1]), json.loads(got[-1])
    assert prep.keys() == jrep.keys()
    assert abs(prep["psnr"] - jrep["psnr"]) <= 0.01, (prep, jrep)
    assert abs(prep["ssim"] - jrep["ssim"]) <= 1e-4, (prep, jrep)
    for k in ("views", "num_gaussians", "path") + (("overflow_views",) if path == "packed"
                                                   else ()):
        assert prep[k] == jrep[k], k
    assert prep.get("overflow_views", 0) == 0 and 15.0 < prep["psnr"] < 60.0
    for name in os.listdir(tmp_path / "jax" / "gt"):
        assert (tmp_path / "port" / "gt" / name).read_bytes() == \
            (tmp_path / "jax" / "gt" / name).read_bytes()
    assert sorted(os.listdir(tmp_path / "port" / "renders")) == sorted(
        os.listdir(tmp_path / "jax" / "renders"))


def test_eval_app_empty_split(tmp_path, monkeypatch):
    (tmp_path / "poses.json").write_text(json.dumps([]))
    scene_path = str(tmp_path / "s.ply")
    save_ply(make_random_scene(10, seed=0), scene_path)
    with pytest.raises(SystemExit, match="no views"):
        _run(eval_app, [scene_path, str(tmp_path), "--height", "32", "--width", "32",
                        "--device", "cpu"], monkeypatch)


@pytest.fixture(scope="module")
def edit_inputs(tmp_path_factory):
    """A degree-2 PLY, a degree-0 .splat and a spacetime degree-1 .gsz,
    written by the JAX package."""
    from gaussianrenderer_tpu.scene.compact import save_compact, save_splat

    root = tmp_path_factory.mktemp("edit")
    paths = [str(root / n) for n in ("a.ply", "b.splat", "c.gsz")]
    save_ply(make_random_scene(300, seed=1, sh_degree=2), paths[0])
    save_splat(make_random_scene(200, seed=2, sh_degree=0), paths[1])
    save_compact(make_random_scene(100, seed=3, sh_degree=1, spacetime=True), paths[2])
    return paths


@pytest.mark.parametrize("ext", [".ply", ".gsz", ".splat"])
def test_edit_app_byte_equal_to_jax(ext, edit_inputs, tmp_path, monkeypatch, capsys):
    """The JAX app's and the port's output files are byte-equal and their
    lines equal, for a merge of three formats with a rotation, a
    translation, a scale, a negative crop in the space-separated form and
    a prune. Both apps read PLY through their default, native, readers."""
    from gaussianrenderer_tpu.apps import edit as jax_edit

    ops = ["--rotate", "0,1,0,90", "--translate", "-1,0.5,0", "--scale", "1.5",
           "--crop", "-4,-9,-9,2,9,9", "--min-opacity", "0.2", "--max-scale", "0.15"]
    texts = []
    for tag, mod, extra in (("jax", jax_edit, []), ("port", edit_app, ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}{ext}")
        assert _run(mod, [out] + edit_inputs + ops + extra, monkeypatch) == 0
        texts.append(capsys.readouterr().out.replace(out, "OUT"))
    assert texts[1] == texts[0]
    assert "merged: 600 gaussians, SH degree 2" in texts[1]
    assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"jax{ext}").read_bytes()


def test_edit_app_rejects_like_jax(edit_inputs, tmp_path, monkeypatch):
    out = str(tmp_path / "o.ply")
    for argv, msg in ((["--rotate", "0,1,0"], "--rotate needs"),
                      (["--rotate", "0,0,0,10"], "--rotate: rotation axis"),
                      (["--translate", "1,2"], "--translate needs"),
                      (["--crop", "1,2,3"], "--crop needs"),
                      (["--min-opacity", "2.0"], "no splats left")):
        with pytest.raises(SystemExit, match=msg):
            _run(edit_app, [out, edit_inputs[1], "--device", "cpu"] + argv, monkeypatch)
    assert edit_app._join_csv_values(["--crop", "-5,1", "--scale", "-2", "--crop", "x"]) == [
        "--crop=-5,1", "--scale", "-2", "--crop", "x"]


def test_frame_timer_matches_jax(monkeypatch):
    """Same EMA arithmetic and report strings as the JAX FrameTimer on the
    same clock readings."""
    stamps = [0.0]
    for i in range(200):
        stamps.append(stamps[-1] + 0.004 + 0.003 * ((i * 7) % 5))

    def clock():
        it = iter(stamps)
        return types.SimpleNamespace(perf_counter=lambda: next(it))

    monkeypatch.setattr(jax_timing, "time", clock())
    monkeypatch.setattr(timing, "time", clock())
    ours, theirs = timing.FrameTimer(report_every=50), jax_timing.FrameTimer(report_every=50)
    reports = 0
    for _ in stamps:
        got, want = ours.tick(), theirs.tick()
        assert got == want
        reports += got is not None
    assert reports == 4 and ours.ema_ms == theirs.ema_ms


def test_device_time_on_the_cpu():
    calls = []
    ms = timing.device_time(lambda x: calls.append(x), torch.zeros(3), iters=4, reps=2,
                            floor=123.0, perturb_ints=False)
    assert len(calls) == 1 + 4 * 2 and ms >= 0.0
    assert timing.measure_floor(reps=3, device="cpu") >= 0.0
