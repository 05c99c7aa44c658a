"""The culled session of test_torch_sat_session.py on a camera orbiting 3°
a frame (the step of the JAX package's
``test_orbit_coherence_psnr_and_risk``), with the default dilation of
one block: every frame equals the JAX package's (counts, per-tile
counts and cutoff images exactly, framebuffers ≥ 60 dB), and the culled
frames stay ≥ 40 dB against the port's unculled renders, the repo's
fidelity gate. A file of its own to keep each file's run short.
"""

import pytest

import gaussianrenderer_tpu_torch as gt

from test_torch_common import psnr_np
from test_torch_sat_session import check_frames_match_jax, make_setup, run_session


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.fixture(scope="module")
def frames(setup):
    return run_session(setup, orbit=True)


def test_orbit_frames_match_jax(frames):
    check_frames_match_jax(frames, "orbit")


def test_orbit_stays_within_fidelity_gate(setup, frames):
    _, ps, _, cfg = setup
    assert cfg.sat_dilate == 1
    for fr in frames[1:]:
        unculled, _ = gt.render_frame(ps, fr["pp"], cfg)
        assert psnr_np(fr["pfb"], unculled.numpy()) >= 40.0
