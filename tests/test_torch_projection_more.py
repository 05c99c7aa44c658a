"""More projection cases of the port against the JAX package (the split
keeps each file's run short; tolerances as in test_torch_projection.py)."""

import pytest

from test_torch_projection import _project_both, assert_projected_match


@pytest.mark.parametrize(
    "case",
    ["tiles16", "k_sigma_small", "k_sigma_big", "unquantized", "deg3",
     "portrait_near"],
)
def test_preprocess_matches_more(case):
    jp, pp = _project_both(case)
    assert int(pp.valid.sum()) > 0
    assert_projected_match(jp, pp)
