"""Run one cell of the benchmark of ``gaussianrenderer_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process: load and warm up the cell (set-up), measure for ``--seconds``
seconds, check what the timed path produced against the plain reference
under ``benchmark/reference/``, and print one JSON object as the last line
of standard output. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a traced window, with the device's
busy seconds and the longest device operations and idle gaps. Each number
the check compares is printed beside its limit, as the last lines of
standard error and under ``checks``, the last key of the result.

The run needs as many CUDA cards as the cell asks for and fails without
them. Compiled kernels stay in ``build/`` inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed places inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import core  # noqa: E402


def run_cell(cell: core.Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, fault=None) -> dict:
    """Drive one run of ``cell`` and assemble its result object."""
    out = cell.driver.run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                          t_start=t_start, fault=fault)
    rec = out["record"]
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = out["checks"]
    result = {
        "correct": out["failed"] == 0 and all(v <= lim for v, lim in checks.values()),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": out["device"],
    }
    if trace:
        result["device"].update(busy_s=rec.busy_s, window_s=rec.trace_window_s)
        result["breakdown"] = out["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = core.cell(args.workload)
    import torch

    # One process with few host threads: the host's work is the program's
    # dispatch, and idle threads spinning beside it only add noise.
    torch.set_num_threads(2)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = core.forbidden_loaded()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
