"""More whole-frame cases of the port against the JAX package and the
oracle (gates as in test_torch_render.py; split to keep each file short)."""

import pytest

from test_torch_render import check_case


@pytest.mark.parametrize("case", ["spacetime", "tiles16"])
def test_frame_matches_jax_and_oracle_more(case):
    check_case(case)
