"""Time the PyTorch port's CUDA compositor by band size, on the card.

Without an alpha row, ``gaussianrenderer_tpu_torch/csrc/tile_render2.cu``
cuts each tile into bands of about ``kBandRects`` 8×4-pixel rectangles,
one thread block each. This probe builds that source with ``kBandRects``
set to each of 4, 8, 16 and 32 (32: one block a 32×32 tile, no bands)
under ``build/band_probe/``, then times each build, in turns, on the
compositor's inputs of chip_smoke.py's two 1080p frames (bench_3m and
trained_500k, rgb without an alpha row). Every build must give the
shipped build's framebuffer bit for bit: banding only changes which
block composites a pixel.

    python3 tools/torch_band_probe.py [--reps 20]

Prints the card's name and power limit, then one JSON line per frame;
exits 1 without a CUDA card or if a build disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

SIZES = (4, 8, 16, 32)
LINE = "constexpr int kBandRects = 8;"


def build_variants(_build):
    """One library per band size, compiled in parallel; {size: CDLL}."""
    with open(os.path.join(_build.CSRC_DIR, "tile_render2.cu")) as f:
        src = f.read()
    if src.count(LINE) != 1:
        raise RuntimeError(f"tile_render2.cu no longer holds {LINE!r}")
    out_dir = os.path.join(REPO, "build", "band_probe")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = []
    for n in SIZES:
        cu = os.path.join(out_dir, f"tile_render2_bands{n}.cu")
        with open(cu, "w") as f:
            f.write(src.replace(LINE, f"constexpr int kBandRects = {n};"))
        so = cu[:-3] + ".so"
        proc = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", so, cu],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        procs.append((n, so, proc))
    libs = {}
    for n, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for kBandRects = {n}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn, (restype, argtypes) in _build._SIGNATURES["tile_render2"].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[n] = lib
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_band_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import gaussianrenderer_tpu_torch as gt
    from gaussianrenderer_tpu_torch import _build

    print(cs.card_line(), flush=True)
    libs = build_variants(_build)
    shipped = _build.load("tile_render2")
    ok = True
    for label, setup in (("bench_3m", cs.bench_3m_setup),
                         ("trained_500k", cs.trained_500k_setup)):
        scene, cam, cfg = setup()
        inst = cs.packed_frame(gt, scene, cam, cfg, False)
        kw = cs.comp_kwargs(cfg, False)
        ref = gt.composite_tiles_packed(inst.packed_feats, inst.tile_start,
                                        inst.tile_count, **kw)

        def with_lib(lib):
            def run():
                _build._loaded["tile_render2"] = lib
                return gt.composite_tiles_packed(inst.packed_feats, inst.tile_start,
                                                 inst.tile_count, **kw)
            return run

        runs = [with_lib(libs[n]) for n in SIZES]
        try:
            diff = {n: float((run() - ref).abs().max()) for n, run in zip(SIZES, runs)}
            ms = cs.cuda_ms_turns(torch, runs, args.reps)
        finally:
            _build._loaded["tile_render2"] = shipped
        ok = ok and all(d == 0.0 for d in diff.values())
        print(json.dumps({"frame": label, "reps": args.reps,
                          "kernel_ms_by_band_rects": dict(zip(SIZES, ms)),
                          "max_abs_diff_vs_shipped": diff}), flush=True)
        del scene, inst, ref, runs
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
