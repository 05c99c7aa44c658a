"""The harness's shared machinery, driven by data.

``BENCHMARK.json`` names every part; each part is a file of its own that
this module finds by that name:

- a configuration: ``benchmark/configs/<config>.json``;
- a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``kind``
  names the general driver that reads it, ``benchmark/drivers/<kind>.py``;
- a metric: ``benchmark/metrics/<metric>.py``, a reader whose
  ``read(rec)`` returns the metric from a run's :class:`Record`, or None
  where the run holds nothing to read;
- a cell's limits on its correctness numbers: ``benchmark/limits/<cell>.json``.

Adding a configuration, a mix or a metric adds files and entries only.
Also here: the statistics every metric shares, and the reduction of a
profiler trace to busy time, kernel times and idle gaps.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import statistics
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: Top-level module names that no process of the benchmark may hold.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gaussianrenderer_tpu")


def load_json(path: str) -> Any:
    with open(path) as fh:
        return json.load(fh)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def part_path(folder: str, name: str, ext: str, bench_dir: str = BENCH_DIR) -> str:
    path = os.path.join(bench_dir, folder, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder[:-1]} file for {name!r} ({path})")
    return path


def load_module(path: str):
    """A module from a file whose name may hold dots (a metric's name)."""
    name = "benchmark_part_" + os.path.abspath(path).replace(os.sep, "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with every part it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: str = BENCH_DIR

    @property
    def driver(self):
        return load_module(part_path("drivers", self.traffic["kind"], ".py", self.bench_dir))

    def reader(self, metric: str):
        return load_module(part_path("metrics", metric, ".py", self.bench_dir))


def metric_applies(metric: dict, cell: str, e2e_names: Sequence[str]) -> bool:
    """A metric with ``workloads`` belongs to those cells; one without, to
    every cell that reports the end-to-end metric it moves (or, for an
    end-to-end metric, to every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, man: Optional[dict] = None, bench_dir: str = BENCH_DIR) -> Cell:
    man = man if man is not None else manifest()
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    root = os.path.dirname(bench_dir)
    config = load_json(os.path.join(root, conf["file"]))
    if "scene" in config:
        config["scene_path"] = os.path.join(root, config["scene"])
    e2e = [m for m in man["end_to_end"] if metric_applies(m, name, ())]
    names = [m["name"] for m in e2e]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=load_json(part_path("traffic", w["traffic"], ".json", bench_dir)),
        limits=load_json(part_path("limits", name, ".json", bench_dir)),
        end_to_end=e2e,
        per_layer=[m for m in man["per_layer"] if metric_applies(m, name, names)],
        bench_dir=bench_dir,
    )


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers. Times in seconds
    unless a name says otherwise."""

    #: Set-up, less the reference's own work in it (its renders of the
    #: inputs), which no change to the program can move.
    setup_s: float = 0.0
    #: The measured window: its length and the units of work it held.
    window_s: float = 0.0
    units: int = 0
    #: Host seconds of each call into the system's entry, enqueue only.
    enqueue_s: List[float] = dataclasses.field(default_factory=list)
    #: CUDA-event milliseconds of calls into each layer, by layer name.
    spans_ms: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    #: Profiler device milliseconds of the kernels of a layer's calls.
    device_ms: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    #: The traced window (a device-only profile): its length on the host's
    #: clock, the device's busy seconds, kernel device seconds by name,
    #: and the units of work it held.
    trace_window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace_units: int = 0
    #: Per-unit matched readings for rooflines: the kernel's device seconds
    #: on an input and the reference's counts of the work it needs.
    roofline: List[dict] = dataclasses.field(default_factory=list)


# ------------------------------------------------------------- statistics
def rate(units: int, seconds: float) -> float:
    return units / seconds


def mean(values: Sequence[float]) -> Optional[float]:
    return statistics.fmean(values) if values else None


# ------------------------------------------------------------------ trace
def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], start: float, stop: float,
              host: Sequence[Tuple[float, float, str]], top: int = 10) -> List[list]:
    """The ``top`` longest stretches of [start, stop] with no kernel on the
    device, each named by what the host was doing: the innermost host span
    open when the gap began, then the last host span begun before it
    ended (the call whose work the device waited for)."""
    gaps, end = [], start
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if stop > end:
        gaps.append((end, stop))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        open_ = [h for h in host if h[0] <= a < h[1]]
        before = [h for h in host if h[0] <= b]
        first = min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "host idle"
        last = max(before, key=lambda h: (h[0], h[0] - h[1]))[2] if before else first
        out.append([first if last == first else f"{first} > {last}", b - a])
    return out


#: The host span a driver opens around its traced window.
TRACED_WINDOW = "traced_window"


def reduce_profile(prof, annotations=()) -> dict:
    """Busy seconds, kernel seconds by name, the window and the idle gaps
    of a ``torch.profiler`` run, from its device and host events; the
    window is the host span :data:`TRACED_WINDOW` where there is one, else
    the extent of the host events, else of the device's (a profile of the
    device alone). The driver's own ``record_function`` labels
    (``annotations``), which the profiler also shows on the device's
    timeline, are not device work."""
    from torch.autograd import DeviceType

    skip = {TRACED_WINDOW, *annotations}
    dev, host = [], []
    for e in prof.events():
        if e.time_range is None:
            continue
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if b > a and e.name not in skip:
                dev.append((a, b, e.name))
        elif b > a:
            host.append((a, b, e.name))
    windows = [(a, b) for a, b, n in host if n == TRACED_WINDOW]
    if windows:
        start, stop = windows[0]
        dev = [(max(a, start), min(b, stop), n) for a, b, n in dev if b > start and a < stop]
    elif host:
        start, stop = min(h[0] for h in host), max(h[1] for h in host)
    elif dev:
        start, stop = min(d[0] for d in dev), max(d[1] for d in dev)
    else:
        start = stop = 0.0
    spans = [(a, b) for a, b, _ in dev]
    kernels: Dict[str, float] = {}
    for a, b, n in dev:
        kernels[n] = kernels.get(n, 0.0) + (b - a)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": stop - start,
        "busy_s": union_length(spans),
        "kernel_s": kernels,
        "device_ops": [[n, s] for n, s in top],
        "idle_gaps": idle_gaps(spans, start, stop, host),
    }


def kernel_seconds(kernels: Dict[str, float], match) -> Optional[float]:
    """Summed device seconds of the kernels whose name ``match`` accepts;
    None where none ran."""
    hits = [s for n, s in kernels.items() if match(n)]
    return sum(hits) if hits else None


# ------------------------------------------------------- the program's side
def steady_host() -> None:
    """Before a window: collect once and move every object that set-up
    left into the collector's permanent generation, so that no collection
    in the window walks them. (Keeping the driving thread on one core was
    tried and made the host-bound cell slower.)"""
    gc.collect()
    gc.freeze()


def sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def port_camera(gt, position, target, fov_y: float, aspect: float, near: float, far: float,
                k_sigma: float, device: str):
    """The program's camera parameters for a look-at pose, built as its
    viewer builds them (``scene/camera.Camera``)."""
    cam = gt.Camera()
    cam.set_position(list(position))
    cam.set_look_at(list(target))
    cam.set_fov_y(fov_y)
    cam.set_aspect_ratio(aspect)
    cam.set_clipping_planes(near, far)
    cam.update_camera_matrices()
    return cam.params(k_sigma, device=device)


def device_record(device: str, chips: int) -> dict:
    """The result's ``device`` object; read before the reference runs."""
    import torch

    cuda = device.startswith("cuda")
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name() if cuda else "cpu", "count": chips,
            "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))
