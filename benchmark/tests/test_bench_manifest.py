"""``BENCHMARK.json`` against the contract the harness is written to, and
every name in it resolved to its files."""

import json
import os
import re

import pytest

from benchmark import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = core.manifest()


def line_ok(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(core.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    cells = len(MAN["workloads"])
    # A full check of 24 cells fits the driver's 43200 s.
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_command_and_paths():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(MAN["command"]) <= 32 and all(line_ok(w) for w in MAN["command"])
    files = [w for w in MAN["command"] if os.path.exists(os.path.join(core.ROOT, w))]
    assert all(any(f.startswith(p + "/") for p in MAN["paths"]) for f in files)


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_keys(section):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
    }[section]
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert set(e) <= allowed, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if "why" in e:
            assert line_ok(e["why"])
        if "layer" in e:
            assert line_ok(e["layer"])


def test_metric_sources_and_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


def test_configs_resolve():
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert c["name"] in used and line_ok(c["source"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        conf = core.load_json(os.path.join(core.ROOT, c["file"]))
        assert conf["name"] == c["name"] and set(c["reduced"]) <= set(conf)
        assert os.path.isfile(os.path.join(core.ROOT, conf["scene"]))
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
        # SH degree is the per-splat width: it is never cut.
        assert "sh_degree" not in c["reduced"] and conf["sh_degree"] == 3


def test_workloads_resolve_every_part():
    pairs = set()
    four = 0
    for w in MAN["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        cell = core.cell(w["name"], MAN)
        assert hasattr(cell.driver, "run") and hasattr(cell.driver, "control")
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(cell.reader(m["name"]), "read")
        for m in cell.per_layer:
            assert m["moves"] in e2e
        assert cell.limits
        for v in cell.limits.values():
            # Set between the program's largest sound reading and the
            # control's or a fault's least, with room on both sides.
            assert v["lower"] < v["limit"] < v["upper"], (w["name"], v)
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_per_layer_metric_layers_and_cells():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_files_under_paths_are_named_from_name_characters():
    for p in MAN["paths"]:
        for dirpath, _, files in os.walk(os.path.join(core.ROOT, p)):
            if "__pycache__" in dirpath:
                continue
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), core.ROOT)
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_manifest_is_json_that_round_trips():
    with open(os.path.join(core.ROOT, "BENCHMARK.json")) as fh:
        assert json.load(fh) == MAN
