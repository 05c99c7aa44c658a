"""The entry point: without a CUDA card, or outside a full checkout, a
run fails and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import core


def run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "train-500k-640x480", "--seed",
         str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = run(core.ROOT)
    assert res.returncode != 0
    assert "CUDA" in res.stderr
    assert not res.stdout.strip()


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copytree(core.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = run(str(tmp_path), env)
    assert res.returncode != 0
    assert not res.stdout.strip()
