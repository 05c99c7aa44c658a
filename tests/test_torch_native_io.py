"""The port's native readers (``gaussianrenderer_tpu_torch/native``) and its
emission probes against the JAX package, on the CPU.

``load_ply`` and ``read_points3d_bin`` read through C++ by default in both
packages, from the same sources built with the same g++ flags, so the
defaults are held bit for bit against each other, and so are the NumPy
paths (``use_native=False``). Between the two paths of one package the
f32 ``exp`` of the C++ reader rounds opacities and scales up to 4 ulp
apart. The probes ``effective_hist``, ``area_histogram`` and
``emission_total`` are held against the JAX package's (jitted XLA, no
Pallas) and against the port's own ``render_frame`` stats.
"""

import os
import struct

import numpy as np
import pytest

from gaussianrenderer_tpu import render as jrender
from gaussianrenderer_tpu.scene import colmap as jcolmap
from gaussianrenderer_tpu.scene import io as jio

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch import render as prender
from gaussianrenderer_tpu_torch import _build
from gaussianrenderer_tpu_torch.native import ply_native
from gaussianrenderer_tpu_torch.ops import instances as pinst
from gaussianrenderer_tpu_torch.scene import colmap
from gaussianrenderer_tpu_torch.scene import io as pio

from test_torch_common import REPO, PORT_DIR, both_cameras, both_configs, both_scenes

FIELDS = ("positions", "sh", "opacity", "scales", "quats")
#: Fields whose load-time activation (sigmoid, exp) the C++ and the NumPy
#: readers round apart, by at most this many ulp (measured on both repo
#: PLYs: 4 in opacity, 2 in scales).
ACTIVATED = ("opacity", "scales")
MAX_ULP = 4
#: Where the libraries build when no test points elsewhere.
DEFAULT_BUILD_DIR = _build.NATIVE.build_dir
REPO_PLYS = {"trained_500k": os.path.join(REPO, "data", "trained_500k.ply"),
             "trained_100k": os.path.join(REPO, "data", "trained_100k.ply")}


@pytest.fixture(scope="module")
def plys(tmp_path_factory):
    """The repo's two trained PLYs and a seeded 3000-splat degree-3 PLY
    written by the JAX package."""
    path = str(tmp_path_factory.mktemp("ply") / "seeded.ply")
    jio.save_ply(jio.make_random_scene(3000, seed=11, sh_degree=3), path)
    return {**REPO_PLYS, "seeded": path}


def bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def assert_bit_equal(js, ps, label):
    for f in FIELDS + ("time_params",):
        a, b = getattr(js, f), getattr(ps, f)
        if a is None:
            assert b is None, f"{label}: {f}"
            continue
        x, y = bits(a), bits(b.numpy())
        assert x.shape == y.shape and np.array_equal(x, y), (
            f"{label}: {f} differs in {int((x != y).sum()) if x.shape == y.shape else x.shape}")


@pytest.mark.parametrize("degree", [0, 1, 2, 3, None])
@pytest.mark.parametrize("name", ["seeded", "trained_100k", "trained_500k"])
def test_load_ply_bit_equal_to_jax(plys, name, degree):
    """Default against default and NumPy path against NumPy path are bit
    for bit the JAX package's; the port's two paths agree within 4 ulp in
    opacity and scales and bit for bit elsewhere."""
    path = plys[name]
    native = gt.load_ply(path, max_sh_degree=degree, device="cpu")
    assert_bit_equal(jio.load_ply(path, max_sh_degree=degree), native, "default")
    numpy_path = gt.load_ply(path, degree, False, device="cpu")
    assert_bit_equal(jio.load_ply(path, max_sh_degree=degree, use_native=False),
                     numpy_path, "use_native=False")
    if degree is None:  # what the apps load
        assert_bit_equal(jio.load_scene(path), gt.load_scene(path, device="cpu"),
                         "load_scene")
    for f in FIELDS:
        a, b = bits(getattr(native, f).numpy()), bits(getattr(numpy_path, f).numpy())
        if f in ACTIVATED:
            ulp = int(np.abs(a.astype(np.int64) - b).max(initial=0))
            assert ulp <= MAX_ULP, f"{f}: {ulp} ulp"
        else:
            assert np.array_equal(a, b), f


def test_spacetime_ply_takes_the_numpy_path(tmp_path):
    """A 4D PLY goes to the NumPy reader in both packages: its time
    parameters come back, bit for bit."""
    path = str(tmp_path / "st.ply")
    jio.save_ply(jio.make_random_scene(300, seed=4, spacetime=True), path)
    ps = gt.load_ply(path, device="cpu")
    assert ps.time_params is not None and ps.time_params.shape == (300, 5)
    assert_bit_equal(jio.load_ply(path), ps, "4D default")


def _bad_plys(tmp_path, good):
    with open(good, "rb") as f:
        data = f.read()
    ascii_ply = tmp_path / "ascii.ply"
    ascii_ply.write_text("ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\n"
                         "property float y\nproperty float z\nend_header\n0 0 0\n")
    garbage = tmp_path / "garbage.ply"
    garbage.write_bytes(b"\x00\x01garbage" * 50)
    truncated = tmp_path / "truncated.ply"
    truncated.write_bytes(data[: len(data) - 100])
    return {"ascii": str(ascii_ply), "garbage": str(garbage), "truncated": str(truncated)}


@pytest.mark.parametrize("kind", ["ascii", "garbage", "truncated"])
def test_bad_ply_raises_like_jax(tmp_path, plys, kind):
    path = _bad_plys(tmp_path, plys["seeded"])[kind]
    for use_native in (True, False):
        with pytest.raises(ValueError) as jax_err:
            jio.load_ply(path, use_native=use_native)
        with pytest.raises(ValueError) as port_err:
            gt.load_ply(path, use_native=use_native, device="cpu")
        assert str(port_err.value) == str(jax_err.value)


_STANDARD = (["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
             + [f"f_rest_{i}" for i in range(9)]
             + ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"])
#: Headers the C++ reader would read outside its buffers or leave a field
#: of unset for, and one whose body is far shorter than its count.
_UNSAFE = {
    "scale_3": (_STANDARD + ["scale_3"], None),
    "rot_-1": (_STANDARD + ["rot_-1"], None),
    "f_dc_100000": (_STANDARD + ["f_dc_100000"], None),
    "f_rest_-1": (["f_rest_-1"] + _STANDARD, None),
    "f_rest_2147483648": (_STANDARD + ["f_rest_2147483648"], None),
    "no_opacity": ([n for n in _STANDARD if n != "opacity"], None),
    "no_scale_2": ([n for n in _STANDARD if n != "scale_2"], None),
    "no_x": (_STANDARD[1:], None),
    "count_1e6": (_STANDARD, 10 ** 6),
}


@pytest.mark.parametrize("case", sorted(_UNSAFE))
def test_unsafe_ply_header_takes_the_numpy_path(tmp_path, case):
    """The C++ reader uses a property's index as written and leaves a
    missing field unset; such a header never reaches it. The port then
    loads what the NumPy reader loads, bit for bit the JAX package's
    NumPy reader, or raises the same ValueError."""
    names, count = _UNSAFE[case]
    n = 50
    body = np.random.default_rng(3).normal(0, 1, (n, len(names))).astype("<f4")
    path = str(tmp_path / f"{case}.ply")
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {count or n}"]
    header += [f"property float {name}" for name in names] + ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(body.tobytes())
    with pytest.raises(ValueError):
        ply_native.load(path, 2)
    try:
        expected = jio.load_ply(path, use_native=False)
    except ValueError as jax_err:
        with pytest.raises(ValueError) as port_err:
            gt.load_ply(path, device="cpu")
        assert str(port_err.value) == str(jax_err)
        return
    assert_bit_equal(expected, gt.load_ply(path, device="cpu"), case)


def _points_file(path, n=300, seed=5):
    """A points3D.bin with tracks of 0 to 8 observations."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", n))
        for j in range(n):
            fh.write(struct.pack("<Q", j * 7 + 1))
            fh.write(struct.pack("<ddd", *rng.normal(0, 10, 3)))
            fh.write(struct.pack("<BBB", *rng.integers(0, 256, 3)))
            fh.write(struct.pack("<d", rng.uniform(0, 2)))
            track = int(rng.integers(0, 9))
            fh.write(struct.pack("<Q", track))
            fh.write(struct.pack("<ii", 1, 0) * track)
    return path


def test_points3d_native_equals_loop(tmp_path):
    """The port's C++ reader, the JAX package's and the Python loop give
    equal arrays; a truncated file raises on both paths."""
    path = _points_file(str(tmp_path / "points3D.bin"))
    from gaussianrenderer_tpu_torch.native import colmap_native

    outs = [colmap_native.load_points(path), colmap.read_points3d_bin(path),
            jcolmap.read_points3d_bin(path),
            colmap.read_points3d_bin(path, use_native=False)]
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert outs[0][0].shape == (300, 3)
    with open(path, "rb") as fh:
        data = fh.read()
    trunc = str(tmp_path / "trunc.bin")
    with open(trunc, "wb") as fh:
        fh.write(data[: len(data) - 9])
    with pytest.raises(ValueError):
        colmap_native.load_points(trunc)
    for use_native in (True, False):
        with pytest.raises(ValueError, match="truncated"):
            colmap.read_points3d_bin(trunc, use_native=use_native)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded yet."""
    monkeypatch.setattr(_build.NATIVE, "build_dir", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", {})
    return tmp_path


def test_failed_build_raises(fresh_build, plys, monkeypatch):
    """A missing compiler and a failing one raise; no reader falls back to
    the slower Python path for them."""
    def no_fallback(*args, **kwargs):
        raise AssertionError("fell back to the NumPy reader")

    monkeypatch.setattr(pio, "_load_ply_numpy", no_fallback)
    points = _points_file(str(fresh_build / "points3D.bin"), n=4)
    bin_dir = fresh_build / "bin"
    bin_dir.mkdir()
    monkeypatch.setenv("PATH", str(bin_dir))
    with pytest.raises(RuntimeError, match="not found"):
        gt.load_ply(plys["seeded"], device="cpu")
    with pytest.raises(RuntimeError, match="not found"):
        colmap.read_points3d_bin(points)
    failing = bin_dir / "g++"
    failing.write_text("#!/bin/sh\necho 'cannot compile today' >&2\nexit 1\n")
    failing.chmod(0o755)
    with pytest.raises(RuntimeError, match="cannot compile today"):
        gt.load_ply(plys["seeded"], device="cpu")
    assert not [n for n in os.listdir(_build.NATIVE.build_dir) if n.endswith(".so")]


def test_libraries_build_under_build_dir(fresh_build, monkeypatch):
    """A fresh build lands in the build directory, named by a hash of the
    source, the flags and the compiler, so another compiler's library is
    never loaded; nothing but the sources sits beside the readers."""
    # $CXX is not read: g++ on PATH builds (the JAX package's choice).
    monkeypatch.setenv("CXX", str(fresh_build / "no-such-compiler"))
    path = _points_file(str(fresh_build / "points3D.bin"), n=3)
    colmap.read_points3d_bin(path)
    built = sorted(os.listdir(_build.NATIVE.build_dir))
    ours = _build.NATIVE.library_path("colmap_loader")
    assert built == [os.path.basename(ours)]
    assert DEFAULT_BUILD_DIR == os.path.join(REPO, "build", "torch_native")
    other = fresh_build / "bin" / "g++"
    other.parent.mkdir()
    other.write_text("#!/bin/sh\necho 'another g++ 1.0'\n")
    other.chmod(0o755)
    monkeypatch.setenv("PATH", f"{other.parent}{os.pathsep}{os.environ['PATH']}")
    assert _build.NATIVE.library_path("colmap_loader") != ours
    native_dir = os.path.join(PORT_DIR, "native")
    left = {n for n in os.listdir(native_dir) if n != "__pycache__"}
    assert left == {"__init__.py", "ply_native.py", "colmap_native.py",
                    "ply_loader.cpp", "colmap_loader.cpp"}
    jax_native = os.path.join(REPO, "gaussianrenderer_tpu", "native")
    for src in ("ply_loader.cpp", "colmap_loader.cpp"):
        with open(os.path.join(native_dir, src), "rb") as a, \
                open(os.path.join(jax_native, src), "rb") as b:
            assert a.read() == b.read(), src


@pytest.mark.parametrize("case", ["seed9", "wide"])
def test_emission_probes_match_jax_and_render(case):
    """tests/test_packed_pipeline.py's 3000-splat 128×160 setup, and the
    same with wide splats: the histogram equals the JAX package's probe
    and the port's packed render's ``area_hist``; the total equals the
    render's ``num_instances``, and the JAX package's ``emission_total``
    where no splat wider than 8 tiles has a dead tile (it counts such a
    splat's whole rect). The JAX package's ``area_histogram`` is its
    ``effective_hist`` over the projection with the cfg's arguments, which
    the port's ``effective_hist`` is held against."""
    h, w = 128, 160
    scale = (0.05, 0.5) if case == "wide" else (0.01, 0.12)
    js, ps = both_scenes(3000, seed=9, scale_range=scale)
    jcfg, pcfg = both_configs(height=h, width=w, compositor="packed")
    jp, pp, _ = both_cameras(w, h, k_sigma=pcfg.k_sigma, pos=(0.0, 0.0, 6.0), fov=60.0)

    jhist = jrender.area_histogram(js, jp, jcfg)
    grid = dict(tiles_x=pcfg.tiles_x, tiles_y=pcfg.tiles_y, tile_w=pcfg.tile_w,
                tile_h=pcfg.tile_h)
    proj = gt.preprocess_gaussians(ps, pp, width=w, height=h, sh_degree=pcfg.sh_degree,
                                   **grid)
    np.testing.assert_array_equal(pinst.effective_hist(proj, **grid).numpy(), jhist)

    hist = prender.area_histogram(ps, pp, pcfg)
    total = prender.emission_total(ps, pp, pcfg)
    assert hist.dtype == np.int64
    np.testing.assert_array_equal(hist, jhist)
    _, stats = gt.render_frame(ps, pp, pcfg)
    np.testing.assert_array_equal(hist, stats.area_hist.numpy())
    assert total == int(stats.num_instances) > 0
    jtotal = jrender.emission_total(js, jp, jcfg)
    if case == "wide":
        assert jtotal > total
    else:
        assert jtotal == total
