"""A cell, a configuration, a traffic mix and a per-layer metric defined
only by new files and entries are found by name, and run, with no edit
to any file that is there."""

import hashlib
import json
import os
import shutil
import time

from benchmark import core
from benchmark import run as runner


def digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_cell_from_new_files_only(tmp_path, tiny_scene):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(core.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = digest(str(bench))

    # New files: a configuration, a mix (of an existing kind), a metric
    # reader and the cell's limits; new entries in the manifest.
    conf = json.loads((bench / "configs" / "trained_500k-sh3.json").read_text())
    conf.update(name="tiny-sh3", scene=os.path.relpath(tiny_scene, str(root)), splats=600,
                train_resolution=[96, 64])
    conf["train"]["rig"].update(views=3, radius=4.0)
    (bench / "configs" / "tiny-sh3.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "traffic" / "train-steps.json").read_text())
    mix.update(position_noise_sigma=0.02)
    (bench / "traffic" / "train-tiny.json").write_text(json.dumps(mix))
    (bench / "metrics" / "steps_seen.py").write_text(
        '"""Steps in the window."""\n\n\ndef read(rec):\n    return rec.units or None\n')
    shutil.copy(bench / "limits" / "train-500k-640x480.json", bench / "limits" / "train-tiny.json")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-sh3", "source": "https://arxiv.org/abs/2308.04079",
                           "file": "benchmark/configs/tiny-sh3.json", "reduced": ["splats"],
                           "why": "a test"})
    man["workloads"].append({"name": "train-tiny", "config": "tiny-sh3", "traffic": "train-tiny",
                             "chips": 1, "why": "a test"})
    man["end_to_end"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                              "bound": 0.05, "source": "host_clock", "workloads": ["train-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    cell = core.cell("train-tiny", core.manifest(str(root)), bench_dir=str(bench))
    assert cell.config["name"] == "tiny-sh3" and cell.traffic["position_noise_sigma"] == 0.02
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "steps_seen"]
    res = runner.run_cell(cell, 2**31 + 3, 0.3, False, "cpu", time.perf_counter())
    assert res["correct"], res
    assert res["metrics"]["steps_seen"]["value"] == res["attempted"] > 0
    assert "setup_s" in res["metrics"]
    after = digest(str(bench))
    assert {k: v for k, v in after.items() if k in before} == before
