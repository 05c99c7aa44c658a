#!/usr/bin/env python3
"""chip_smoke.py's multi-device phases alone, and the a2a_q order probe.

    python3 tools/torch_multichip_phases.py [--phases 3m,train,order]

Needs a CUDA card; builds the port's kernels first, so no rank runs
nvcc. ``3m`` is chip_smoke's ``multichip-3m`` and ``train`` its
``multichip-train-500k``, with the same checks and JSON lines. ``order``
renders bench_3m on 2 ranks sharing the card through the ``a2a_q``
exchange twice, from the same exchanged records: in the JAX package's
receive order (straddlers and wide records after the first-destination
ones) and re-sorted into scene order as ``render_frame_multichip`` does,
and prints each frame's max |Δ| from ``render_frame``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def order_rank(mesh):
    torch, _, gt, par, mc = cs.mc_modules()
    from gaussianrenderer_tpu_torch.ops.instances import decode_record_rows, encode_record_rows

    scene, cam, cfg = cs.bench_3m_setup(device=mesh.device)
    camp = cam.params(cfg.k_sigma, device=mesh.device)
    ref = gt.render_frame(scene, camp, cfg)[0]
    shard = par.shard_scene(scene, mesh)
    geo = mc._geometry(cfg, mesh.size, mesh.rank, None, None)
    proj = mc._probe(shard, camp, cfg)
    bounds = tuple(i * (cfg.tiles_y // mesh.size) for i in range(mesh.size + 1))
    rows, index = mc._exchange_a2a(
        mesh, encode_record_rows(proj), proj.tile_min[:, 1], proj.tile_max[:, 1],
        proj.valid, bounds=bounds, tmin_x=proj.tile_min[:, 0], tmax_x=proj.tile_max[:, 0])
    out = {"rank": mesh.rank, "records": int(rows.shape[1])}
    for label, r in (("jax_order", rows),
                     ("scene_order", rows[:, torch.sort(index, stable=True).indices])):
        proj_g, _ = decode_record_rows(r, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                                       tile_w=cfg.tile_w, tile_h=cfg.tile_h)
        fb, _, _ = mc._packed_strip_tail(mc._rebase(proj_g, cfg, geo), cam=camp, cfg=cfg,
                                         geo=geo)
        full = mc._reassemble(mc._all_gather(mesh, fb[None], 0), cfg, mesh.size, None, None)
        err = (full - ref).abs()
        out[label] = {"max_abs_err": float(err.max()),
                      "pixels_over_2e-4": int((err.amax(0) > 2e-4).sum())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="3m,train,order")
    phases = ap.parse_args(argv).phases.split(",")
    import torch

    import gaussianrenderer_tpu_torch as gt
    from gaussianrenderer_tpu_torch import _build, parallel

    if not torch.cuda.is_available():
        cs.log("torch_multichip_phases: needs a CUDA card")
        return 1
    card = cs.card_line()
    cs.out({"card": card, "build_seconds": _build.build_all()})
    for name in _build.SOURCES:
        _build.load(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    if "3m" in phases:
        with cs.Phase("multichip-3m", torch):
            res = cs.phase_multichip_3m(torch, gt, cs.bench_3m_setup(), card)
        cs.out({"kernel_launches": res["kernel_launches"], "launches": res["launches"]})
        torch.cuda.empty_cache()
    if "train" in phases:
        with cs.Phase("multichip-train-500k", torch):
            res = cs.phase_multichip_train(torch, gt, cs.trained_500k_setup()[0], card)
        cs.out({"launches": res["launches"]})
    if "order" in phases:
        with cs.Phase("a2a-order", torch):
            ranks = parallel.spawn(order_rank, cs.MC_D_SMALL, backend="gloo", device="cuda",
                                   timeout=cs.MC_SPAWN_TIMEOUT)
        print(json.dumps({"a2a_order": "bench_3m, D=2 gloo, one card", "card": card,
                          "ranks": ranks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
