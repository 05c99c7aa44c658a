"""The port's config, scene container, generator, PLY reader and Morton
order against the JAX package: equal fields, equal arrays."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gaussianrenderer_tpu import config as jax_config
from gaussianrenderer_tpu.scene import gaussians as jax_gaussians
from gaussianrenderer_tpu.scene import io as jax_io

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch import config as port_config
from gaussianrenderer_tpu_torch.scene import gaussians as port_gaussians

from test_torch_common import REPO

TRAINED_PLY = os.path.join(REPO, "tests", "fixtures", "trained.ply")

_DERIVED = ("tile_w", "tile_h", "tiles_x", "tiles_y", "num_tiles",
            "packed_compatible")


@pytest.mark.parametrize(
    "kw",
    [
        {},
        dict(height=600, width=800),
        dict(height=1080, width=1920),
        dict(height=96, width=128, num_tile_x=8, num_tile_y=6),
        dict(height=100, width=100, num_tile_x=3, num_tile_y=3),
        dict(height=4096, width=4096),
        dict(height=512, width=5000),
        dict(height=128, width=160, output_alpha=True, output_depth=True,
             background=(1.0, 1.0, 1.0), packed_chunk=128),
    ],
)
def test_render_config_matches(kw):
    j = jax_config.RenderConfig(**kw)
    p = port_config.RenderConfig(**kw)
    assert [f.name for f in dataclasses.fields(j)] == [
        f.name for f in dataclasses.fields(p)
    ]
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    for name in _DERIVED:
        assert getattr(j, name) == getattr(p, name), name
    for n in (0, 1000, 3_000_000):
        assert j.instance_capacity(n) == p.instance_capacity(n)
    for lanes in (10, 2_000_000):
        assert j.auto_packed_chunk(lanes) == p.auto_packed_chunk(lanes)
    assert dataclasses.asdict(j.with_resolution(72, 88)) == dataclasses.asdict(
        p.with_resolution(72, 88)
    )


@pytest.mark.parametrize(
    "spec", [None, "white", "BLACK", "0.1,0.2,0.3", "1,0,1", "2,0,0", "1,2", "x"]
)
def test_parse_color_matches(spec):
    try:
        want = jax_config.parse_color(spec)
    except ValueError:
        with pytest.raises(ValueError):
            port_config.parse_color(spec)
        return
    assert port_config.parse_color(spec) == want


@pytest.mark.parametrize(
    "kw",
    [
        dict(num=500, seed=0),
        dict(num=300, seed=7, sh_degree=3),
        dict(num=300, seed=1, sh_degree=0),
        dict(num=400, seed=9, spacetime=True),
        dict(num=400, seed=5, scale_range=(0.05, 0.5), extent=4.0),
    ],
)
def test_make_random_scene_equal_arrays(kw):
    js = jax_io.make_random_scene(**kw)
    ps = gt.make_random_scene(device="cpu", **kw)
    for f in ("positions", "sh", "opacity", "scales", "quats", "time_params"):
        a, b = getattr(js, f), getattr(ps, f)
        if a is None:
            assert b is None, f
            continue
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
    assert ps.num_gaussians == js.num_gaussians
    assert ps.sh_degree == js.sh_degree
    assert ps.is_spacetime == js.is_spacetime
    assert str(ps.device) == "cpu"


@pytest.mark.parametrize("degree", [0, 1, 2, 3, None])
def test_load_ply_matches_numpy_and_native(degree):
    """Each reader bit for bit against the JAX package's reader of the
    same flag: the native readers (the default) build from the same C++
    source with the same flags."""
    for use_native in (False, True):
        ps = gt.load_ply(TRAINED_PLY, max_sh_degree=degree, use_native=use_native,
                         device="cpu")
        js = jax_io.load_ply(TRAINED_PLY, max_sh_degree=degree, use_native=use_native)
        for f in ("positions", "sh", "opacity", "scales", "quats"):
            np.testing.assert_array_equal(
                np.asarray(getattr(js, f)), getattr(ps, f).numpy(),
                err_msg=f"{f} native={use_native}",
            )
        assert ps.time_params is None


def test_load_ply_spacetime_fields(tmp_path):
    scene = jax_io.make_random_scene(200, seed=4, spacetime=True)
    path = str(tmp_path / "st.ply")
    jax_io.save_ply(scene, path)
    js = jax_io.load_ply(path, use_native=False)
    ps = gt.load_ply(path, device="cpu")
    np.testing.assert_array_equal(np.asarray(js.time_params), ps.time_params.numpy())
    np.testing.assert_array_equal(np.asarray(js.sh), ps.sh.numpy())


def test_load_ply_rejects_bad_files(tmp_path):
    ascii_ply = tmp_path / "a.ply"
    ascii_ply.write_bytes(
        b"ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\nend_header\n1\n"
    )
    with pytest.raises(ValueError, match="unsupported PLY format"):
        gt.load_ply(str(ascii_ply), device="cpu")
    short = tmp_path / "s.ply"
    short.write_bytes(
        b"ply\nformat binary_little_endian 1.0\nelement vertex 4\n"
        b"property float x\nproperty float y\nproperty float z\nend_header\n"
        + np.zeros(5, "<f4").tobytes()
    )
    with pytest.raises(ValueError, match="truncated"):
        gt.load_ply(str(short), device="cpu")
    notply = tmp_path / "n.ply"
    notply.write_bytes(b"hello\n")
    with pytest.raises(ValueError, match="magic"):
        gt.load_ply(str(notply), device="cpu")


def test_morton_codes_and_order_match():
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(3000, 3)).astype(np.float32)
    pos[5] = np.nan
    pos[17, 1] = np.inf
    np.testing.assert_array_equal(
        jax_gaussians.morton_codes(pos), port_gaussians.morton_codes(pos)
    )
    js = jax_io.make_random_scene(2000, seed=3).morton_sorted()
    ps = gt.make_random_scene(2000, seed=3, device="cpu").morton_sorted()
    for f in ("positions", "sh", "opacity", "scales", "quats"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ps, f).numpy())


def test_scene_reorder():
    ps = gt.make_random_scene(50, seed=1, spacetime=True, device="cpu")
    order = np.arange(50)[::-1].copy()
    r = ps.reorder(torch.from_numpy(order))
    np.testing.assert_array_equal(r.positions.numpy(), ps.positions.numpy()[order])
    np.testing.assert_array_equal(r.time_params.numpy(), ps.time_params.numpy()[order])
