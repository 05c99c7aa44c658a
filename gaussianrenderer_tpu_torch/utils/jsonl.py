"""JSONL benchmark sink (reference ``radix_test.cpp:33-61`` analog).

The reference's only structured observability is the JSONL writer of its
sort benchmark (algo, GPU, SM count, N, seed, device/wall ms, Gitems/s,
correctness booleans). Same record shape here. Every record carries the
device it was measured on, the torch/CUDA pair it ran under and, on a
card, its power limit (a card set below 700 W runs slower under load).
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import time
from typing import Optional

import torch

from gaussianrenderer_tpu_torch._device import resolve_device


def power_limit(index: int = 0) -> Optional[str]:
    """Card ``index``'s power limit as ``nvidia-smi --query-gpu=name,
    power.limit`` gives it (e.g. ``"700.00 W"``), or None where it does
    not answer."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or len(lines) <= index:
        return None
    return lines[index].rsplit(",", 1)[-1].strip()


def device_info(device="cuda") -> dict:
    dev = resolve_device(device)
    info = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if dev.type == "cuda":
        return {
            "device": torch.cuda.get_device_name(dev),
            "platform": "gpu",
            "num_devices": torch.cuda.device_count(),
            **info,
            "power_limit": power_limit(dev.index or 0),
        }
    return {"device": platform.processor() or platform.machine() or "cpu",
            "platform": "cpu", "num_devices": 1, **info}


class JsonlWriter:
    def __init__(self, path: Optional[str], echo: bool = True, device="cuda"):
        self.path = path
        self.echo = echo
        self._static = {**device_info(device), "ts": time.time()}
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, **fields) -> None:
        rec = {**self._static, **fields}
        line = json.dumps(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, file=sys.stderr, flush=True)
