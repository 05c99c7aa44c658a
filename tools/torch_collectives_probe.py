#!/usr/bin/env python3
"""Which torch.distributed collectives a backend takes on CUDA tensors.

    python3 tools/torch_collectives_probe.py [--ranks 2] [--device cuda]

Starts ``--ranks`` processes that share one card (or run on the CPU with
``--device cpu``) in a gloo group, and a one-rank NCCL group when a card
is present, and calls each collective the multi-device port uses on a
small tensor: all_gather, all_gather_into_tensor, all_to_all_single with
even and uneven splits, all_reduce SUM and MAX, broadcast and barrier.
Prints one JSON line per backend: each collective's "ok" (and its
result checked) or its error's first line.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import traceback


def _calls(dist, torch, rank, world, dev):
    def all_gather():
        x = torch.full((3,), float(rank), device=dev)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return all(bool((p == r).all()) for r, p in enumerate(parts))

    def all_gather_into_tensor():
        x = torch.full((3,), float(rank), device=dev)
        out = torch.empty((3 * world,), device=dev)
        dist.all_gather_into_tensor(out, x)
        return bool((out.view(world, 3) == torch.arange(world, device=dev)[:, None]).all())

    def all_to_all_even():
        x = torch.arange(world, device=dev, dtype=torch.int32) + 10 * rank
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out.tolist() == [10 * s + rank for s in range(world)]

    def all_to_all_uneven():
        # Rank r sends r + c + 1 rows of 7 int32 to rank c.
        sizes = [rank + c + 1 for c in range(world)]
        x = torch.cat([torch.full((n, 7), 100 * rank + c, device=dev, dtype=torch.int32)
                       for c, n in enumerate(sizes)])
        recv = [s + rank + 1 for s in range(world)]
        out = torch.empty((sum(recv), 7), device=dev, dtype=torch.int32)
        dist.all_to_all_single(out, x, recv, sizes)
        want = torch.cat([torch.full((n, 7), 100 * s + rank, dtype=torch.int32)
                          for s, n in enumerate(recv)])
        return bool((out.cpu() == want).all())

    def all_reduce_sum():
        x = torch.full((2,), float(rank + 1), device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return float(x[0]) == world * (world + 1) / 2

    def all_reduce_max():
        x = torch.tensor([rank], device=dev, dtype=torch.int32)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return int(x[0]) == world - 1

    def broadcast():
        x = torch.full((2,), float(rank), device=dev)
        dist.broadcast(x, src=0)
        return float(x[0]) == 0.0

    def barrier():
        dist.barrier()
        return True

    return dict(all_gather=all_gather, all_gather_into_tensor=all_gather_into_tensor,
                all_to_all_single_even=all_to_all_even,
                all_to_all_single_uneven=all_to_all_uneven, all_reduce_sum=all_reduce_sum,
                all_reduce_max=all_reduce_max, broadcast=broadcast, barrier=barrier)


def _rank(rank, world, backend, device, store, queue):
    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    res = {}
    for name, fn in _calls(dist, torch, rank, world, dev).items():
        try:
            res[name] = "ok" if fn() else "wrong result"
        except Exception as e:  # the probe's purpose is to record refusals
            res[name] = (str(e).strip().splitlines() or [type(e).__name__])[0][:200]
            if "wrong" not in res[name]:
                traceback.print_exc(limit=1)
    queue.put((rank, res))
    dist.destroy_process_group()


def probe(world, backend, device):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(prefix="gr_probe_"), "store")
    procs = [ctx.Process(target=_rank, args=(r, world, backend, device, store, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, res = queue.get(timeout=180)
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return {"backend": backend, "device": device, "ranks": world, "results": results[0],
            "ranks_agree": all(results[r] == results[0] for r in results)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    print(json.dumps(probe(args.ranks, "gloo", args.device)), flush=True)
    if args.device.startswith("cuda") and torch.cuda.is_available():
        print(json.dumps(probe(1, "nccl", args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
