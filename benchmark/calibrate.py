"""Readings the limits of ``correct`` are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 3 \
        [--control float32-tf32 --control-seeds 4,5,6] \
        [--faults half_batch,altered_loss --fault-seeds 7,8,9]

For each seed a run of the cell with a short window, as ``run.py`` makes
it (the program's readings: each limit's lower reading is the largest of
these); the control, the plain reference computed in the precision below
the configuration's and put in the program's place (the upper reading);
and runs with a fault planted in the timed path. Prints one JSON line
each. Not run by the benchmark's own runs.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import core  # noqa: E402
from benchmark import run as runner  # noqa: E402

CONTROLS = {"float32-tf32": ("float32", True)}


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", choices=sorted(CONTROLS))
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark.reference import render as R

    cell = core.cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        res = runner.run_cell(cell, seed, args.seconds, False, args.device, t0)
        print(json.dumps({"reading": "program", "seed": seed, "correct": res["correct"],
                          "checks": res["checks"], "metrics": res["metrics"],
                          "s": time.perf_counter() - t0}), flush=True)
    if args.control:
        dtype, tf32 = CONTROLS[args.control]
        prec = R.Precision(getattr(torch, dtype), tf32)
        for seed in seeds(args.control_seeds):
            t0 = time.perf_counter()
            nums = cell.driver.control(cell, seed=seed, device=args.device, prec=prec)
            print(json.dumps({"reading": "control", "control": args.control, "seed": seed,
                              "numbers": nums, "s": time.perf_counter() - t0}), flush=True)
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in seeds(args.fault_seeds):
            t0 = time.perf_counter()
            res = runner.run_cell(cell, seed, args.seconds, False, args.device, t0, fault=fault)
            print(json.dumps({"reading": "fault", "fault": fault, "seed": seed,
                              "correct": res["correct"], "checks": res["checks"],
                              "s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"done": True, "s": time.perf_counter() - T_START,
                      "memory_peak_bytes": torch.cuda.max_memory_allocated()
                      if args.device == "cuda" else 0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
