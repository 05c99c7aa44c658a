"""Shared setups for the PyTorch port's tests, and the port's boundary tests.

The port (``gaussianrenderer_tpu_torch``) is held against the JAX package
on the CPU: inputs are made with NumPy from a seed, carried to both
packages (``gaussianrenderer_tpu_torch.convert``), and compared. The
tests in this file check the port's boundaries: it imports nothing of
JAX or of the JAX package, its CUDA entry points refuse to fall back to
the CPU, and ``chip_smoke.py`` fails where there is no card.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.config import RenderConfig as JaxConfig
from gaussianrenderer_tpu.scene.camera import Camera as JaxCamera
from gaussianrenderer_tpu.scene.io import make_random_scene as jax_make_scene

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.convert import to_torch_camera, to_torch_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "gaussianrenderer_tpu_torch")


def np_tree(x):
    """A JAX container with every leaf as a NumPy array."""
    return jax.tree.map(np.asarray, x)


def jax_camera(w, h, pos=(0.5, -0.4, 5.5), fov=55.0, near=0.2):
    cam = JaxCamera()
    cam.set_position(list(pos))
    cam.set_look_at([0.0, 0.0, 0.0])
    cam.set_fov_y(fov)
    cam.set_aspect_ratio(w / h)
    cam.set_clipping_planes(near, 100.0)
    cam.update_camera_matrices()
    return cam


def both_cameras(w, h, k_sigma=3.0, **kw):
    """(JAX CameraParams, port CameraParams on the CPU, JAX Camera)."""
    cam = jax_camera(w, h, **kw)
    jp = cam.params(k_sigma)
    return jp, to_torch_camera(np_tree(jp), device="cpu"), cam


def both_scenes(n, seed=0, **kw):
    """The same seeded scene in both packages (port on the CPU)."""
    js = jax_make_scene(n, seed=seed, **kw)
    return js, to_torch_scene(np_tree(js), device="cpu")


def both_configs(**kw):
    return JaxConfig(**kw), gt.RenderConfig(**kw)


def needle_scene(n=600, seed=3):
    """Thin anisotropic splats (scale ratios up to ~100:1) as NumPy arrays,
    in both packages."""
    from gaussianrenderer_tpu.scene.gaussians import GaussianScene

    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    sh = np.zeros((n, 27), np.float32)
    sh[:, :3] = rng.normal(0, 1, (n, 3))
    op = rng.uniform(0.2, 0.99, n).astype(np.float32)
    sc = np.stack(
        [rng.uniform(0.1, 0.6, n), rng.uniform(0.002, 0.01, n),
         rng.uniform(0.002, 0.01, n)], 1,
    ).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    js = GaussianScene(pos, sh, op, sc, q)
    return js, to_torch_scene(js, device="cpu")


@pytest.fixture
def one_torch_thread():
    """torch on one intra-op thread for the test: the suite runs one
    worker process per core, and each worker's torch spinning up a thread
    per core makes the large elementwise passes of the plain compositors
    stall on descheduled threads (a 1 s test took over 100 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def psnr_np(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


# ------------------------------------------------------------ boundary tests
_IMPORT_RE = re.compile(
    r"^\s*(import\s+(jax|gaussianrenderer_tpu)\b|from\s+(jax|gaussianrenderer_tpu)\b)",
    re.MULTILINE,
)


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax():
    """Neither the port nor chip_smoke.py imports JAX or the JAX package
    (``gaussianrenderer_tpu_torch`` itself is allowed)."""
    assert len(_port_files()) > 10
    offenders = []
    for path in _port_files():
        with open(path) as f:
            src = f.read()
        for m in _IMPORT_RE.finditer(src):
            offenders.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_port_import_leaves_jax_unloaded():
    """Importing the whole port in a fresh interpreter loads no JAX module."""
    code = (
        "import sys, gaussianrenderer_tpu_torch, chip_smoke\n"
        "import gaussianrenderer_tpu_torch.utils\n"
        "from gaussianrenderer_tpu_torch.apps import (camera_test, cull_sort_test, edit,"
        " eval, fit, matrix_test, onesweep, parser_test, radix_test, train_test,"
        " window_test)\n"
        "from gaussianrenderer_tpu_torch.scene import blender, colmap, compact\n"
        "from gaussianrenderer_tpu_torch import native, parallel, viewer, web_viewer\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'gaussianrenderer_tpu' or m.startswith('gaussianrenderer_tpu.')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_exports_the_jax_package_names():
    """Every name the JAX package exports at the top level is exported by
    the port too."""
    import gaussianrenderer_tpu

    missing = sorted(set(gaussianrenderer_tpu.__all__) - set(gt.__all__))
    assert not missing, missing
    assert all(hasattr(gt, name) for name in gt.__all__)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run there")
    with pytest.raises(RuntimeError, match="cuda"):
        gt.make_random_scene(10, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        gt.Camera().params(3.0)
    with pytest.raises(RuntimeError, match="cuda"):
        gt.load_ply(os.path.join(REPO, "tests", "fixtures", "trained.ply"))
    with pytest.raises(RuntimeError, match="cuda"):
        gt.satcull.initial_cutoff(4, 3, 32, 32)
    # The lookup wrapper runs its plain version only for CPU tensors: any
    # other device launches the kernel or raises.
    with pytest.raises(ValueError, match="device"):
        gt.table_lookup(torch.zeros(8, device="meta"),
                        torch.zeros(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="device"):
        gt.matmul_blocked(torch.zeros((128, 128), dtype=torch.bfloat16, device="meta"),
                          torch.zeros((128, 128), dtype=torch.bfloat16, device="meta"),
                          128, 128, 128)
    with pytest.raises(ValueError, match="device"):
        gt.block_sort_runs(torch.zeros((9, 256), dtype=torch.int64, device="meta"), run=256)
    # The harness utilities measure on the card or raise.
    from gaussianrenderer_tpu_torch import utils

    with pytest.raises(RuntimeError, match="cuda"):
        utils.measure_floor()
    with pytest.raises(RuntimeError, match="cuda"):
        utils.JsonlWriter(None)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when there is
    no CUDA card, and also when it stands alone without the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    res = subprocess.run(
        [sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
