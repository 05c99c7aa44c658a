"""The port's scene formats and generators (``scene/compact.py``,
``scene/io.load_scene``, ``make_surface_scene``, ``make_clustered_scene``)
against the JAX package's on the CPU.

Gates:
- ``save_compact`` (q16, q8; static, spacetime, with non-finite splats)
  and ``save_splat`` (with non-finite splats and importance ties) write
  files byte-equal to the JAX package's, with equal stats;
- ``load_compact``, ``load_splat`` and ``load_scene`` (every extension,
  ``max_sh_degree`` truncation) give arrays bit-equal to JAX's, on seeded
  scenes and on ``data/trained_surface_100k.gsz``;
- ``make_surface_scene`` and ``make_clustered_scene`` (static and
  spacetime) give arrays bit-equal to JAX's for the same seed;
- a q16 reload renders within 55 dB of the original and a ``.splat``
  reload within 35 dB at SH degree 0 (``tests/test_compact.py``'s gates),
  through the port's plain packed compositor.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.scene import compact as jcompact
from gaussianrenderer_tpu.scene import io as jio

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.convert import to_torch_scene

from test_torch_common import REPO, np_tree, one_torch_thread, psnr_np  # noqa: F401

FIELDS = ("positions", "sh", "opacity", "scales", "quats", "time_params")
SURFACE_100K = os.path.join(REPO, "data", "trained_surface_100k.gsz")


def assert_scenes_equal(port, ref):
    """Every field bit-equal (NaN where NaN), the port's on the CPU."""
    for f in FIELDS:
        p, r = getattr(port, f), getattr(ref, f)
        if r is None:
            assert p is None, f
            continue
        assert p.dtype == torch.float32 and p.device.type == "cpu", f
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=f)


def scene_pair(n=600, seed=3, sh_degree=2, spacetime=False, bad=False):
    """A clustered scene in both packages; ``bad`` plants a NaN position,
    a NaN SH coefficient, an inf scale and a NaN opacity."""
    js = jio.make_clustered_scene(n, seed=seed, sh_degree=sh_degree, spacetime=spacetime)
    if bad:
        arrays = {f: np.asarray(getattr(js, f)).copy() for f in FIELDS[:5]}
        arrays["positions"][7] = np.nan
        arrays["sh"][3, -1] = np.nan
        arrays["scales"][9, 0] = np.inf
        arrays["opacity"][11] = np.nan
        js = js._replace(**{f: jnp.asarray(a) for f, a in arrays.items()})
    return js, to_torch_scene(np_tree(js), device="cpu")


@pytest.mark.parametrize("profile,spacetime,bad", [
    ("q16", False, False), ("q8", False, False), ("q16", True, True), ("q8", True, False),
])
def test_save_compact_byte_equal_to_jax(tmp_path, profile, spacetime, bad):
    js, ps = scene_pair(spacetime=spacetime, bad=bad)
    jpath, ppath = str(tmp_path / "jax.gsz"), str(tmp_path / "port.gsz")
    jstats = jcompact.save_compact(js, jpath, profile=profile)
    pstats = gt.save_compact(ps, ppath, profile=profile)
    assert pstats == jstats and pstats["n"] == 600 - 4 * bad
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    assert_scenes_equal(gt.load_compact(ppath, device="cpu"), jcompact.load_compact(jpath))
    with pytest.raises(ValueError, match="unknown profile"):
        gt.save_compact(ps, ppath, profile="q4")


def test_load_compact_bit_equal_on_the_repo_scene():
    port = gt.load_compact(SURFACE_100K, device="cpu")
    assert port.num_gaussians == 100_000
    assert_scenes_equal(port, jcompact.load_compact(SURFACE_100K))


@pytest.mark.parametrize("bad", [False, True])
def test_save_splat_byte_equal_to_jax(tmp_path, bad):
    js, _ = scene_pair(n=300, seed=4, sh_degree=1, bad=bad)
    # Importance ties (equal opacity and volume) keep their order only
    # under the stable argsort.
    arrays = {f: np.asarray(getattr(js, f)).copy() for f in ("opacity", "scales")}
    arrays["opacity"][20:40] = 0.5
    arrays["scales"][20:40] = 0.01
    js = js._replace(**{f: jnp.asarray(a) for f, a in arrays.items()})
    ps = to_torch_scene(np_tree(js), device="cpu")
    jpath, ppath = str(tmp_path / "jax.splat"), str(tmp_path / "port.splat")
    jstats = jcompact.save_splat(js, jpath)
    assert gt.save_splat(ps, ppath) == jstats
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    unsorted = str(tmp_path / "unsorted.splat")
    jcompact.save_splat(js, jpath, sort_by_importance=False)
    gt.save_splat(ps, unsorted, sort_by_importance=False)
    assert open(unsorted, "rb").read() == open(jpath, "rb").read()
    back = gt.load_splat(unsorted, device="cpu")
    # .splat drops only non-finite DC colours: the NaN rest coefficient stays.
    assert back.sh.shape[1] == 27 and back.num_gaussians == 300 - 3 * bad
    assert_scenes_equal(back, jcompact.load_splat(jpath))


@pytest.mark.parametrize("ext", [".ply", ".gsz", ".splat"])
def test_load_scene_matches_jax(tmp_path, ext):
    js, _ = scene_pair(n=200, seed=5, sh_degree=2)
    path = str(tmp_path / f"s{ext}")
    {".ply": jio.save_ply, ".gsz": jcompact.save_compact,
     ".splat": jcompact.save_splat}[ext](js, path)
    # PLY: the default (native) reader against the JAX package's default,
    # and the NumPy reader against its NumPy reader.
    flags = ({}, {"use_native": False}) if ext == ".ply" else ({},)
    for extra in flags:
        for deg in (None, 0, 1, 2, 3):
            assert_scenes_equal(gt.load_scene(path, max_sh_degree=deg, device="cpu", **extra),
                                jio.load_scene(path, max_sh_degree=deg, **extra))
    if ext != ".ply":
        with pytest.raises(TypeError, match="unsupported"):
            gt.load_scene(path, use_native=True, device="cpu")


def test_load_errors(tmp_path):
    bad = tmp_path / "x.gsz"
    bad.write_bytes(b"NOPExxxxxxxx")
    with pytest.raises(ValueError, match="magic"):
        gt.load_compact(str(bad), device="cpu")
    odd = tmp_path / "bad.splat"
    odd.write_bytes(b"\x00" * 33)
    with pytest.raises(ValueError, match="not a multiple"):
        gt.load_splat(str(odd), device="cpu")


@pytest.mark.parametrize("spacetime", [False, True])
@pytest.mark.parametrize("kind", ["surface", "clustered"])
def test_generators_bit_equal_to_jax(kind, spacetime):
    if kind == "surface":
        ref = jio.make_surface_scene(3001, seed=11, sh_degree=2, spacetime=spacetime)
        port = gt.make_surface_scene(3001, seed=11, sh_degree=2, spacetime=spacetime,
                                     device="cpu")
    else:
        ref = jio.make_clustered_scene(5003, seed=12, extent=3.0, sh_degree=3,
                                       spacetime=spacetime)
        port = gt.make_clustered_scene(5003, seed=12, extent=3.0, sh_degree=3,
                                       spacetime=spacetime, device="cpu")
    assert_scenes_equal(port, ref)


def _frame(scene, cfg):
    cam = gt.Camera()
    cam.set_position([0.0, 0.5, 6.0])
    cam.set_look_at([0.0, 0.0, 0.0])
    cam.set_fov_y(60.0)
    cam.set_aspect_ratio(cfg.width / cfg.height)
    cam.set_clipping_planes(0.2, 100.0)
    cam.update_camera_matrices()
    fb, _ = gt.render_frame(scene, cam.params(cfg.k_sigma, device="cpu"), cfg)
    return fb.numpy()


@pytest.mark.usefixtures("one_torch_thread")
def test_reloads_render_like_the_original(tmp_path):
    """tests/test_compact.py's render gates on the port: q16 > 55 dB,
    .splat > 35 dB at SH degree 0 (its DC-only encoding is the intended
    loss at higher degrees)."""
    scene = gt.make_clustered_scene(4000, seed=3, sh_degree=2, device="cpu")
    cfg = gt.RenderConfig(height=96, width=128)
    gt.save_compact(scene, str(tmp_path / "s.gsz"))
    q16 = psnr_np(_frame(scene, cfg), _frame(gt.load_scene(str(tmp_path / "s.gsz"),
                                                           device="cpu"), cfg))
    assert q16 > 55.0, q16
    cfg0 = gt.RenderConfig(height=96, width=128, sh_degree=0)
    gt.save_splat(scene, str(tmp_path / "s.splat"))
    splat = psnr_np(_frame(scene, cfg0), _frame(gt.load_scene(str(tmp_path / "s.splat"),
                                                              device="cpu"), cfg0))
    assert splat > 35.0, splat
