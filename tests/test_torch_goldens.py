"""The five pinned golden frames (tests/fixtures/golden_*.npz) rendered by
the port on the CPU, and chip_smoke.py's rebuild of their setups held
equal to tools/make_golden_fixture.py's. Gate: PSNR ≥ 40 dB, the JAX
package's own bar for its packed pipeline against the same files."""

import dataclasses
import os
import sys

import numpy as np
import pytest

import chip_smoke

from test_torch_common import REPO, psnr_np

sys.path.insert(0, os.path.join(REPO, "tools"))
from make_golden_fixture import golden_setup as jax_golden_setup  # noqa: E402

import gaussianrenderer_tpu_torch as gt  # noqa: E402


@pytest.mark.parametrize("name", chip_smoke.GOLDEN_NAMES)
def test_golden_frame(name):
    scene, cam, cfg, tv = chip_smoke.golden_setup(name, device="cpu")
    js, jcam, jcfg, jtv = jax_golden_setup(name)
    assert tv == jtv
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for f in ("view", "proj", "r_cam", "position"):
        np.testing.assert_array_equal(getattr(cam, f), getattr(jcam, f))
    for f in ("positions", "sh", "opacity", "scales", "quats", "time_params"):
        a, b = getattr(js, f), getattr(scene, f)
        assert (a is None) == (b is None), f
        if a is not None:
            # The JAX setup reads trained.ply with its native C++ loader.
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)

    fb, stats = gt.render_frame(scene, cam.params(cfg.k_sigma, device="cpu"), cfg, tv)
    golden = np.load(
        os.path.join(REPO, "tests", "fixtures", f"golden_{name}.npz")
    )["framebuffer"]
    assert fb.shape == golden.shape
    assert not bool(stats.overflow)
    score = psnr_np(fb.numpy(), golden)
    assert score >= 40.0, f"golden_{name}: {score:.2f} dB"
