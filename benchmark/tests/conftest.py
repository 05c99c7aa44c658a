"""The benchmark's tests run from the repository root: ``python -m pytest
benchmark/tests``. They use the CPU and a few threads; a test that needs
a card decides so inside itself and skips without one."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def tiny_scene(tmp_path_factory):
    from benchmark.tests import tiny

    return tiny.write_ply(str(tmp_path_factory.mktemp("scene") / "tiny.ply"))
