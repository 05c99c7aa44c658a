"""A run with its timed path broken underneath comes out not correct:
once for each fault a cell can have. The harness's look for a card is
skipped (``run_cell`` on the CPU, a tiny cell); the rest of the run is
the one ``run.py`` makes."""

import time

import pytest

from benchmark import run as runner
from benchmark.tests import tiny

CASES = [
    # A training step that returns its state unchanged.
    ("trained_500k-sh3", "train-steps", "state_unchanged"),
    ("trained_2m-sh3", "train-steps", "state_unchanged"),
    # Half of the batch (the frame's rows) left out, the mean over the rest.
    ("trained_500k-sh3", "train-steps", "half_batch"),
    # An answer altered where it is produced: the step's loss.
    ("trained_500k-sh3", "train-steps", "altered_loss"),
]


@pytest.mark.parametrize("config,traffic,fault", CASES)
def test_fault_is_not_correct(tiny_scene, config, traffic, fault):
    cell = tiny.cell(config, traffic, tiny_scene)
    res = runner.run_cell(cell, 2**31 + 19, 0.3, False, "cpu", time.perf_counter(), fault=fault)
    assert not res["correct"], res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("config,traffic", [("trained_500k-sh3", "train-steps"),
                                            ("trained_2m-sh3", "train-steps")])
def test_sound_run_is_correct(tiny_scene, config, traffic):
    cell = tiny.cell(config, traffic, tiny_scene)
    res = runner.run_cell(cell, 2**33 + 5, 0.3, False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
