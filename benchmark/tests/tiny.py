"""Tiny cells for the CPU tests: a seeded scene file of a few hundred
splats, and a configuration and mix of the benchmark cut to a size the
CPU runs in seconds (the port's plain PyTorch paths stand in for its
kernels)."""

from __future__ import annotations

import numpy as np

from benchmark import core

N_SPLATS = 600
#: The training cells' limits are the benchmark's own.
TRAIN_LIMITS = "train-500k-640x480"
E2E = ["train_steps_per_s", "setup_s"]


def write_ply(path: str, n: int = N_SPLATS, seed: int = 0) -> str:
    """A 3DGS PLY (SH degree 1) of ``n`` splats around the origin."""
    rng = np.random.default_rng(seed)
    cols = {
        **{a: rng.uniform(-1.2, 1.2, n) for a in "xyz"},
        **{f"f_dc_{i}": rng.normal(0, 1, n) for i in range(3)},
        **{f"f_rest_{i}": rng.normal(0, 0.2, n) for i in range(9)},
        "opacity": rng.normal(0.5, 1.5, n),
        **{f"scale_{i}": np.log(rng.uniform(0.03, 0.15, n)) for i in range(3)},
        **{f"rot_{i}": rng.normal(0, 1, n) for i in range(4)},
    }
    names = list(cols)
    body = np.stack([cols[k] for k in names], 1).astype("<f4")
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {k}" for k in names] + ["end_header"]
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        body.tofile(fh)
    return path


def cell(config: str, traffic: str, scene_path: str, **traffic_overrides) -> core.Cell:
    """The configuration and mix of these names on the tiny scene: 128×96
    training views, four of them."""
    conf = core.load_json(core.part_path("configs", config, ".json"))
    conf["scene_path"] = scene_path
    conf["train_resolution"] = [128, 96]
    conf["train"]["rig"].update(views=4, radius=4.0)
    tr = core.load_json(core.part_path("traffic", traffic, ".json"))
    limits = core.load_json(core.part_path("limits", TRAIN_LIMITS, ".json"))
    tr.update(traffic_overrides)
    metrics = [{"name": n, "unit": "-"} for n in E2E]
    return core.Cell(name=f"{config}.{traffic}", chips=1, config=conf, traffic=tr,
                     limits=limits, end_to_end=metrics, per_layer=[])
