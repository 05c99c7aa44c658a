"""The port's harness apps (``gaussianrenderer_tpu_torch/apps``) and
utilities (``utils``), driven through ``main()`` on the CPU at the sizes
``tests/test_apps.py`` gives the JAX apps, and checked as it checks them;
where both apps print the same thing (the camera's matrices, the parsed
count), against the JAX app's own output.
"""

import json
import os
import sys
import types

import pytest
import torch

from gaussianrenderer_tpu.apps import camera_test as jax_camera_test
from gaussianrenderer_tpu.apps import parser_test as jax_parser_test
from gaussianrenderer_tpu.scene.io import make_random_scene, save_ply
from gaussianrenderer_tpu.utils import timing as jax_timing

from gaussianrenderer_tpu_torch.apps import (
    camera_test,
    matrix_test,
    onesweep,
    parser_test,
    radix_test,
)
from gaussianrenderer_tpu_torch.utils import timing


@pytest.fixture(scope="module")
def ply_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("apps") / "scene.ply")
    save_ply(make_random_scene(2000, seed=0), path)
    return path


def _run(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    return mod.main()


def test_parser_test(ply_file, monkeypatch, capsys):
    assert _run(jax_parser_test, [ply_file], monkeypatch) == 0
    want = capsys.readouterr().out
    assert _run(parser_test, [ply_file, "--device", "cpu"], monkeypatch) == 0
    got = capsys.readouterr().out
    assert "2000 gaussians" in got
    assert got == want
    assert _run(parser_test, [], monkeypatch) == 2


def test_camera_test_matches_jax(monkeypatch, capsys):
    assert jax_camera_test.main() == 0
    want = capsys.readouterr().out
    assert _run(camera_test, ["--device", "cpu"], monkeypatch) == 0
    got = capsys.readouterr().out
    assert "proj" in got
    assert got == want


def test_onesweep_harness(monkeypatch, capsys):
    rc = _run(
        onesweep,
        ["--minN", "100", "--maxN", "5000", "--growth", "3.0", "--device", "cpu"],
        monkeypatch,
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "PASS" in out and "0 failed" in out
    rc = _run(onesweep, ["--minN", "1000", "--maxN", "1010", "--mode", "consecutive",
                         "--device", "cpu"], monkeypatch)
    assert rc == 0
    assert "10 passed, 0 failed" in capsys.readouterr().out


@pytest.mark.parametrize("ones", [True, False])
def test_matrix_test_small(ones, monkeypatch, capsys):
    rc = _run(
        matrix_test,
        ["--n", "512", "--bm", "256", "--bn", "256", "--bk", "256",
         "--iters", "1", "--device", "cpu"] + (["--ones"] if ones else []),
        monkeypatch,
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "OK" in out
    assert "matmul_blocked:" in out and "torch_mm:" in out


def test_matrix_test_rejects_non_multiples(monkeypatch):
    with pytest.raises(ValueError, match="block multiples"):
        _run(matrix_test, ["--n", "384", "--bm", "256", "--iters", "1", "--device", "cpu"],
             monkeypatch)


def test_radix_test_bench(monkeypatch, capsys, tmp_path):
    out = tmp_path / "radix_bench.jsonl"
    rc = _run(
        radix_test,
        ["--minN", "512", "--maxN", "2048", "--growth", "4.0", "--iters", "1",
         "--out", str(out), "--device", "cpu"],
        monkeypatch,
    )
    assert rc == 0
    assert "PASS" in capsys.readouterr().err
    lines = [json.loads(l) for l in out.read_text().splitlines()]
    assert len(lines) == 6  # N = 512, 2048 x three algorithms
    assert all(
        rec["nondecreasing"] and rec["matches_oracle"] and rec["radix_matches"]
        for rec in lines
    )
    for rec in lines:
        assert rec["torch"] == torch.__version__ and "jax" not in rec
        assert rec["platform"] == "cpu" and rec["device_ms"] >= 0


def test_radix_test_default_out_is_under_build(monkeypatch, tmp_path):
    """Without ``--out`` the records go to build/radix_bench_port.jsonl, never
    to radix_bench.jsonl, the JAX package's TPU record at the repo root."""
    monkeypatch.chdir(tmp_path)
    rc = _run(radix_test, ["--minN", "512", "--maxN", "512", "--iters", "1",
                           "--device", "cpu"], monkeypatch)
    assert rc == 0
    assert not (tmp_path / "radix_bench.jsonl").exists()
    recs = (tmp_path / "build" / "radix_bench_port.jsonl").read_text().splitlines()
    assert len(recs) == 3


_APPS = {
    "parser_test": (parser_test, [os.path.join(os.path.dirname(__file__), "fixtures",
                                               "trained.ply")]),
    "camera_test": (camera_test, []),
    "onesweep": (onesweep, ["--minN", "100", "--maxN", "200"]),
    "matrix_test": (matrix_test, ["--n", "256", "--bm", "256", "--bn", "256", "--bk", "256"]),
    "radix_test": (radix_test, ["--minN", "512", "--maxN", "512", "--out", ""]),
}


@pytest.mark.parametrize("name", sorted(_APPS))
def test_apps_raise_for_cuda_without_a_card(name, monkeypatch):
    """``--device`` defaults to cuda; without a card every app raises
    rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the apps run there")
    mod, argv = _APPS[name]
    with pytest.raises(RuntimeError, match="cuda"):
        _run(mod, argv, monkeypatch)


def test_frame_timer_matches_jax(monkeypatch):
    """Same EMA arithmetic and report strings as the JAX FrameTimer on the
    same clock readings."""
    stamps = [0.0]
    for i in range(200):
        stamps.append(stamps[-1] + 0.004 + 0.003 * ((i * 7) % 5))

    def clock():
        it = iter(stamps)
        return types.SimpleNamespace(perf_counter=lambda: next(it))

    monkeypatch.setattr(jax_timing, "time", clock())
    monkeypatch.setattr(timing, "time", clock())
    ours, theirs = timing.FrameTimer(report_every=50), jax_timing.FrameTimer(report_every=50)
    reports = 0
    for _ in stamps:
        got, want = ours.tick(), theirs.tick()
        assert got == want
        reports += got is not None
    assert reports == 4 and ours.ema_ms == theirs.ema_ms


def test_device_time_on_the_cpu():
    calls = []
    ms = timing.device_time(lambda x: calls.append(x), torch.zeros(3), iters=4, reps=2,
                            floor=123.0, perturb_ints=False)
    assert len(calls) == 1 + 4 * 2 and ms >= 0.0
    assert timing.measure_floor(reps=3, device="cpu") >= 0.0
