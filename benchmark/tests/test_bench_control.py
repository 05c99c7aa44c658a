"""The control, the reference computed in the precision below the
configuration's and put in the program's place, comes out over the
cell's limits: TF32 for training stated in float32 with TF32 off. At a
tiny size on the CPU here; at the cell's size on a card by
``benchmark/calibrate.py --control``."""

import pytest
import torch

from benchmark.reference import render as R
from benchmark.tests import tiny

CASES = [
    ("trained_500k-sh3", "train-steps", R.Precision(torch.float32, tf32=True)),
    ("trained_2m-sh3", "train-steps", R.Precision(torch.float32, tf32=True)),
]


@pytest.mark.parametrize("config,traffic,prec", CASES, ids=[f"{c[0]}.{c[1]}" for c in CASES])
@pytest.mark.parametrize("seed", [3, 2**32 + 1, 2**31 - 5])
def test_control_fails_a_limit(tiny_scene, config, traffic, prec, seed):
    cell = tiny.cell(config, traffic, tiny_scene)
    numbers = cell.driver.control(cell, seed=seed, device="cpu", prec=prec)
    assert any(v > cell.limits[k]["limit"] for k, v in numbers.items()), numbers


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, 3.0])
    y = R.Precision(torch.float32, tf32=True).operand(x)
    assert y.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 3.0]
    assert R.FP32.operand(x) is x
