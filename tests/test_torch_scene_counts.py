"""Frame counts of the port's emission against the JAX package on a real
trained scene.

The port emits by count → scan → scatter with no tier ladder; the JAX
package emits through a static tier ladder, here recalibrated from the
frame until it does not overflow. Both must then produce the same (splat, tile) set: the culled
count, the total instance count and every tile's instance count are
compared bit-exact. Both packages load the same PLY with their default
(native) readers, which give the same bits, and project with their own
code.

The tests use a small trained capture and a reduced-resolution view of
``data/trained_500k.ply``. The full 1920×1080 frame that ``chip_smoke.py``
renders (``trained_500k``) is counted by running this file as a script::

    PYTHONPATH=. python tests/test_torch_scene_counts.py

which prints both packages' counts (CPU only, a few GiB of memory).
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from gaussianrenderer_tpu.ops.instances import build_packed_instances
from gaussianrenderer_tpu.ops.projection import preprocess_gaussians
from gaussianrenderer_tpu.render import calibrate_tiers
from gaussianrenderer_tpu.scene.io import load_ply as jax_load_ply

import gaussianrenderer_tpu_torch as gt

from test_torch_common import REPO, both_cameras, both_configs

TRAINED_500K = os.path.join(REPO, "data", "trained_500k.ply")
TRAINED_FIXTURE = os.path.join(REPO, "tests", "fixtures", "trained.ply")
#: The training-orbit camera of tools/bench_suite.py config 8 and of
#: chip_smoke.py's trained_500k frame.
ORBIT_CAM = dict(pos=(3.9, 1.7, 3.9), fov=70.0, near=0.2)


def _jax_counts(path, cfg, jcam):
    """The JAX emitter's counts. Its first pass uses the default tier
    ladder; where that overflows (splats wider than the widest tier), the
    ladder is recalibrated from the frame's area histogram and the frame
    emitted again, as ``make_renderer(auto_tier=True)`` does."""
    scene = jax_load_ply(path, max_sh_degree=1)
    geo = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
               tile_h=cfg.tile_h)

    @functools.partial(jax.jit, static_argnames="tiers")
    def run(scene, cam, tiers=None):
        proj = preprocess_gaussians(
            scene, cam, width=cfg.width, height=cfg.height,
            sh_degree=cfg.sh_degree, **geo,
        )
        inst = build_packed_instances(
            proj, near=cam.near, far=cam.far, tiers=tiers, **geo
        )
        return (proj.valid.sum(), inst.total_instances, inst.overflow,
                inst.tile_count, inst.area_hist)

    res = jax.device_get(run(scene, jcam))
    if res[2]:
        tiers = calibrate_tiers(res[4], num_tiles=cfg.num_tiles)
        res = jax.device_get(run(scene, jcam, tiers=tiers))
    culled, total, overflow, tile_count, _ = res
    return int(culled), int(total), bool(overflow), np.asarray(tile_count)


def _port_counts(path, cfg, pcam):
    scene = gt.load_ply(path, max_sh_degree=1, device="cpu")
    geo = dict(tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y, tile_w=cfg.tile_w,
               tile_h=cfg.tile_h)
    proj = gt.preprocess_gaussians(
        scene, pcam, width=cfg.width, height=cfg.height,
        sh_degree=cfg.sh_degree, **geo,
    )
    inst = gt.build_packed_instances(proj, near=pcam.near, far=pcam.far, **geo)
    return (int(proj.valid.sum()), int(inst.total_instances),
            bool(inst.overflow), inst.tile_count.numpy())


def counts_both(path, height, width):
    """(JAX counts, port counts) of one frame of the PLY at ``path`` from
    the orbit camera: each (num_culled, total_instances, overflow,
    per-tile counts)."""
    jcfg, cfg = both_configs(height=height, width=width, sh_degree=1)
    jcam, pcam, _ = both_cameras(width, height, **ORBIT_CAM)
    return (_jax_counts(path, jcfg, jcam),
            _port_counts(path, cfg, pcam))


def _assert_same(jax_c, port_c):
    j_culled, j_total, j_over, j_tiles = jax_c
    p_culled, p_total, p_over, p_tiles = port_c
    assert not j_over, "the JAX tier ladder overflowed after recalibration"
    assert not p_over
    assert (p_culled, p_total) == (j_culled, j_total)
    np.testing.assert_array_equal(p_tiles, j_tiles)


@pytest.mark.parametrize(
    "path,height,width",
    [(TRAINED_FIXTURE, 270, 480), (TRAINED_500K, 135, 240)],
    ids=["fixture-480x270", "trained_500k-240x135"],
)
def test_trained_scene_counts_match_jax(path, height, width):
    jax_c, port_c = counts_both(path, height, width)
    assert port_c[1] > 0
    _assert_same(jax_c, port_c)


def main():
    torch.set_num_threads(min(8, torch.get_num_threads()))
    jax_c, port_c = counts_both(TRAINED_500K, 1080, 1920)
    names = ("num_culled", "num_instances", "overflow")
    print(json.dumps({
        "frame": "trained_500k 1920x1080, camera (3.9, 1.7, 3.9)",
        "jax": dict(zip(names, jax_c[:3])),
        "port": dict(zip(names, port_c[:3])),
        "tiles_differing": int((jax_c[3] != port_c[3]).sum()),
    }))
    _assert_same(jax_c, port_c)


if __name__ == "__main__":
    main()
