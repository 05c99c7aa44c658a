"""The program's own spans, reduced to per-step numbers by layer.

    python3 benchmark/spans.py --workload train-500k-640x480 --seed 7 \
        [--steps 10] [--turns 6 --block 30] [--out chiprun_out/spans.jsonl]

The training step marks its layers with ``gaussianrenderer_tpu_torch/
utils/trace.py`` (``gr.step``, ``gr.projection``, ``gr.tiling``,
``gr.gather``, ``gr.compositor``, ``gr.loss``, ``gr.backward`` and, on
autograd's thread, ``gr.compositor.bwd`` and ``gr.gather.bwd``;
``gr.optimizer``; ``gr.sync.<site>`` around each explicit read of a
device value). :func:`reduce` takes a profile of host and device,
recorded with those spans on, to:

- host self time by layer: a span's length, less what its child ``gr.``
  spans (on any thread: the autograd thread's inside ``gr.backward``)
  and the synchronisation calls inside it cover. A ``gr.sync.`` span is
  its layer's: only the wait in it is taken out;
- device time by layer: each kernel, memset and copy goes to the
  innermost span open on its launching thread at its launch call, found
  by the profiler's correlation id, never by where it ran in time. A
  launch on another thread inside ``gr.backward`` is the rest of the
  backward;
- synchronisations (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize``) inside ``gr.step``: how many, the host's time
  in them, and the device idle that begins while the host is in one;
- device events a step, and two coverages: the share of device time that
  a layer holds, and the share of ``gr.step``'s host time that the
  layers' self times and the synchronisation waits cover.

The spans the profiler also draws on the device's timeline are not
device work and are dropped. :func:`metrics` names the numbers.

The command drives one cell's training step as ``drivers/train_steps.py``
sets it up, with spans off and on: the checked steps from the same start
(their losses, first gradient and change, each leaf's norm, and the
parameters, compared bit for bit); the spans' cost, host time of each
step call and steps a second, in turns of ``--block`` steps; then
``--steps`` steps under the profiler with spans on. One JSON line; not
run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Dict, List, NamedTuple, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import core  # noqa: E402
from benchmark.metrics import _counts  # noqa: E402

PREFIX = "gr."
STEP, BACKWARD, SYNC = "gr.step", "gr.backward", "gr.sync."
#: Runtime calls in which the host waits for the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
#: The layer metrics: the spans whose host self times (``host``) or
#: device times (``device``) each sums.
HOST_METRICS = {
    "projection_host_ms.train": ("gr.projection",),
    "tiling_gather_host_ms.train": ("gr.tiling", "gr.gather"),
    "train_compositor_host_ms.train": ("gr.compositor", "gr.compositor.bwd"),
    "loss_backward_host_ms.train": ("gr.loss", BACKWARD, "gr.gather.bwd"),
    "optimizer_host_ms.train": ("gr.optimizer",),
}
DEVICE_METRICS = {
    "projection_device_ms.train": ("gr.projection",),
    "tiling_gather_device_ms.train": ("gr.tiling", "gr.gather"),
    "loss_backward_rest_device_ms.train": ("gr.loss", BACKWARD, "gr.gather.bwd"),
    "optimizer_device_ms.train": ("gr.optimizer",),
}


class Event(NamedTuple):
    """One event of a profile, times in µs on the profiler's clock.

    ``kind``: ``host`` (an operator or a span, ``corr`` its id), ``runtime``
    (a CUDA runtime or driver call, ``corr`` its launch's correlation id)
    or ``device`` (a kernel, memset or copy, ``corr`` the runtime call's
    id). ``link``: the id of the host event a runtime call or device event
    ran under; ``thread``: the host thread (None where the profiler gives
    it only through ``link``)."""

    name: str
    kind: str
    thread: Optional[int]
    start: float
    end: float
    corr: int = 0
    link: int = 0


def _is_runtime(e) -> bool:
    """A host event of CUDA's runtime or driver. Where the profiler does
    not name an event's activity (before torch 2.12), such a call is the
    host event linked to an operator, or named ``cu...``."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in ("cuda_runtime", "cuda_driver")
    return e.linked_correlation_id() > 0 or e.name().startswith("cu")


def events(prof) -> List[Event]:
    """The :class:`Event` list of a ``torch.profiler.profile`` run."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.name() == "[memory]":
            continue
        if e.device_type() == DeviceType.CUDA:
            out.append(Event(e.name(), "device", None, a, b, e.correlation_id(),
                             e.linked_correlation_id()))
        elif _is_runtime(e):
            out.append(Event(e.name(), "runtime", None, a, b, e.correlation_id(),
                             e.linked_correlation_id()))
        else:
            out.append(Event(e.name(), "host", e.start_thread_id(), a, b, e.correlation_id()))
    return out


def _inside(e: Event, s: Event) -> bool:
    return s.start <= e.start and e.end <= s.end


def _clipped(items, s: Event):
    return [(max(x.start, s.start), min(x.end, s.end)) for x in items
            if x.end > s.start and x.start < s.end]


def _gaps(dev: List[Event], first: float, last: float):
    """The stretches of [first, last] with no device event: (start, end)."""
    gaps, end = [], first
    for a, b in sorted((d.start, d.end) for d in dev if d.end > first and d.start < last):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if last > end:
        gaps.append((end, last))
    return gaps


def _in_sync(t: float, syncs: List[Event]) -> bool:
    return any(e.start <= t < e.end for e in syncs)


def reduce(evs: List[Event]) -> dict:
    """Per-step numbers of a profile with the spans on (module docstring);
    times in ms a step."""
    spans = [e for e in evs if e.kind == "host" and e.name.startswith(PREFIX)]
    layers = [s for s in spans if not s.name.startswith(SYNC)]
    steps = [s for s in spans if s.name == STEP]
    n = len(steps)
    if not n:
        raise ValueError("the profile holds no gr.step span: were the spans on?")
    host_by_id = {e.corr: e for e in evs if e.kind == "host"}
    launches = {e.corr: e for e in evs if e.kind == "runtime"}

    def thread_of(e: Event) -> Optional[int]:
        h = host_by_id.get(e.link)
        return None if h is None else h.thread

    syncs = [e for e in evs if e.kind == "runtime" and e.name.startswith(SYNC_CALLS)
             and any(_inside(e, s) for s in steps)]

    def innermost(thread: Optional[int], t: float) -> Optional[Event]:
        open_ = [s for s in layers if s.start <= t < s.end
                 and (thread is None or s.thread == thread)]
        return max(open_, key=lambda s: s.start) if open_ else None

    # Host: each layer span's self time.
    host_ms: Dict[str, float] = {}
    for s in layers:
        covered = _clipped([c for c in layers if c is not s and _inside(c, s)] + syncs, s)
        self_us = (s.end - s.start) - core.union_length(covered)
        host_ms[s.name] = host_ms.get(s.name, 0.0) + self_us / 1e3 / n
    step_us = sum(s.end - s.start for s in steps)
    sync_us = sum(e.end - e.start for e in syncs)
    layer_us = 1e3 * n * sum(v for k, v in host_ms.items() if k != STEP)

    # Device: each event to the span open at its launch call.
    dev = [e for e in evs if e.kind == "device" and not e.name.startswith(PREFIX)]
    device_ms: Dict[str, float] = {}
    for d in dev:
        call = launches.get(d.corr, d)
        t = call.start
        s = innermost(thread_of(call if call.link else d), t)
        if s is None and any(b.start <= t < b.end for b in layers if b.name == BACKWARD):
            name = BACKWARD
        else:
            name = "outside" if s is None else s.name
        device_ms[name] = device_ms.get(name, 0.0) + (d.end - d.start) / 1e3 / n
    dev_us = sum(d.end - d.start for d in dev)

    # Idle gaps over the steps, each named by the sync or the innermost
    # span open (on any thread) where it begins.
    first, last = min(s.start for s in steps), max(s.end for s in steps)
    gaps = _gaps(dev, first, last)
    idle_by: Dict[str, float] = {}
    for a, b in gaps:
        if _in_sync(a, syncs):
            name = "sync"
        else:
            s = innermost(None, a)
            name = "outside" if s is None else s.name
        idle_by[name] = idle_by.get(name, 0.0) + (b - a) / 1e3 / n

    by_span: Dict[str, list] = {}
    for e in syncs:
        s = [x for x in spans if x.start <= e.start < x.end
             and (thread_of(e) is None or x.thread == thread_of(e))]
        count_ms = by_span.setdefault(max(s, key=lambda x: x.start).name if s else "outside",
                                      [0.0, 0.0])
        count_ms[0] += 1 / n
        count_ms[1] += (e.end - e.start) / 1e3 / n
    return {
        "steps": n,
        "step_host_ms": step_us / 1e3 / n,
        "host_self_ms": host_ms,
        "device_ms": device_ms,
        "device_events": len(dev) / n,
        "syncs": len(syncs) / n,
        "sync_wait_ms": sync_us / 1e3 / n,
        "sync_idle_ms": idle_by.get("sync", 0.0),
        "syncs_by_span": by_span,  # span: [syncs, wait ms] a step
        "busy_ms": (last - first - sum(b - a for a, b in gaps)) / 1e3 / n,
        "window_ms": (last - first) / 1e3 / n,
        "idle_by_span_ms": idle_by,
        "device_covered": (sum(v for k, v in device_ms.items() if k not in (STEP, "outside"))
                           * 1e3 * n / dev_us) if dev_us else None,
        "host_covered": (layer_us + sync_us) / step_us,
    }


def pace(evs: List[Event], steps: int) -> dict:
    """A profile of the device alone (CUDA activity only: kernels and
    runtime calls, no host operators or spans) over ``steps`` steps and
    the synchronize that closes them: the synchronisations, their wait and
    the idle that begins in them, busy and window ms a step, at a pace
    the host's recording slows less."""
    dev = [e for e in evs if e.kind == "device" and not e.name.startswith(PREFIX)]
    calls = [e for e in evs if e.kind == "runtime"]
    last_launch = max(e.start for e in calls if not e.name.startswith(SYNC_CALLS))
    syncs = [e for e in calls if e.name.startswith(SYNC_CALLS) and e.start < last_launch]
    first, last = min(e.start for e in calls), max(d.end for d in dev)
    gaps = _gaps(dev, first, last)
    idle = sum(b - a for a, b in gaps)
    return {"syncs": len(syncs) / steps,
            "sync_wait_ms": sum(e.end - e.start for e in syncs) / 1e3 / steps,
            "sync_idle_ms": sum(b - a for a, b in gaps if _in_sync(a, syncs)) / 1e3 / steps,
            "busy_ms": (last - first - idle) / 1e3 / steps,
            "window_ms": (last - first) / 1e3 / steps, "device_events": len(dev) / steps}


def metrics(red: dict) -> Dict[str, float]:
    """The thirteen per-step numbers, by metric name."""
    out = {m: sum(red["host_self_ms"].get(s, 0.0) for s in names)
           for m, names in HOST_METRICS.items()}
    out.update({m: sum(red["device_ms"].get(s, 0.0) for s in names)
                for m, names in DEVICE_METRICS.items()})
    out.update({"host_syncs.train": red["syncs"], "sync_wait_ms.train": red["sync_wait_ms"],
                "sync_idle_ms.train": red["sync_idle_ms"],
                "kernels_per_step.train": red["device_events"]})
    return out


def segment(step, params, st, view, start: int, steps: int, device: str, host: bool = True):
    """``steps`` steps from view ``start`` under the profiler, spans on,
    recording the host's operators and spans unless ``host`` is False;
    returns the new parameters and state and the profile's :class:`Event`
    list."""
    from torch.profiler import ProfilerActivity, profile

    from gaussianrenderer_tpu_torch.utils import trace

    acts = [ProfilerActivity.CPU] if host else []
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    core.sync(device)
    with trace.enabled(), profile(activities=acts) as prof:
        for k in range(steps):
            params, st, _ = step(params, st, *view(start + k))
        core.sync(device)
    return params, st, events(prof)


# ------------------------------------------------------------- the command
def setup(cell, seed: int, device: str) -> dict:
    """The cell's step, start and views, as ``drivers/train_steps.run``
    sets them up."""
    import random

    import torch

    import gaussianrenderer_tpu_torch as gt

    drv = cell.driver
    conf, tr = cell.config, cell.traffic
    train, sd = conf["train"], conf["sh_degree"]
    (w, h), tile = conf["train_resolution"], train["tile"]
    rcfg = gt.RenderConfig(width=w, height=h, sh_degree=sd, compositor="diff",
                           chunk_size=train["chunk"], num_tile_x=-(-w // tile),
                           num_tile_y=-(-h // tile))
    scene = gt.load_scene(conf["scene_path"], max_sh_degree=sd, device=device)
    width = 3 * (sd + 1) ** 2
    if scene.sh.shape[1] < width:
        scene = scene._replace(sh=torch.nn.functional.pad(scene.sh,
                                                          (0, width - scene.sh.shape[1])))
    truth = gt.SceneParams.from_scene(scene)
    del scene
    dpos = tr["position_noise_sigma"] * drv.noise(truth.positions.shape, seed, device)
    params0 = truth._replace(positions=truth.positions + dpos,
                             raw_opacity=truth.raw_opacity + tr["opacity_logit_shift"])
    del truth, dpos
    views = drv.rig(train)
    r = train["rig"]
    cams = [core.port_camera(gt, p, t, r["fov_y"], w / h, r["near"], r["far"], train["k_sigma"],
                             device) for p, t in views]
    targets = drv.reference_targets(conf, views, device)
    order = random.Random(seed).sample(range(len(views)), len(views))
    o = train["optimizer"]
    opt = gt.make_3dgs_optimizer(
        position_lr_init=o["position_lr_init"], position_lr_final=o["position_lr_final"],
        position_lr_max_steps=o["position_lr_max_steps"], sh_lr=o["sh_lr"],
        sh_rest_div=o["sh_rest_div"], opacity_lr=o["opacity_lr"], scale_lr=o["scale_lr"],
        quat_lr=o["quat_lr"])
    step, _ = gt.make_train_step(rcfg, optimizer=opt, loss_fn=gt.l1_dssim_loss)

    def view(j):
        v = order[j % len(order)]
        return cams[v], targets[v]

    return {"step": step, "opt": opt, "params0": params0, "view": view, "views": len(order),
            "b1": o["b1"], "driver": drv}


def checked(s: dict, n_check: int):
    """The first ``n_check`` steps from the start: their numbers as the
    driver reads them, and the parameters and state after them."""
    import torch

    drv = s["driver"]
    params, st = s["params0"], s["opt"].init(s["params0"])
    losses, first_grad = [], None
    for j in range(n_check):
        params, st, loss = s["step"](params, st, *s["view"](j))
        losses.append(float(loss))
        if j == 0:
            first_grad = {k: float(torch.linalg.vector_norm(torch.nan_to_num(getattr(st.mu, k))))
                          / (1.0 - s["b1"]) for k in drv.LEAVES}
    return ({"losses": losses, "first_grad": first_grad,
             "change": drv.change_norms(params, s["params0"])}, (params, st))


def same_bits(a, b) -> bool:
    """Two (parameters, Adam state) pairs hold the same bits (a NaN in a
    scene file's splat is equal to itself)."""
    import torch

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    ta = [t for t in (*a[0], a[1].count, *a[1].mu, *a[1].nu) if t is not None]
    tb = [t for t in (*b[0], b[1].count, *b[1].mu, *b[1].nu) if t is not None]
    return len(ta) == len(tb) and all(torch.equal(bits(x), bits(y)) for x, y in zip(ta, tb))


def cost(s: dict, params, st, start: int, turns: int, block: int, device: str):
    """Spans off against on, in turns (off, on, on, off, ...): host ms of
    each step call, mean a turn, and steps a second to the synchronize
    that closes the turn. No profiler runs. Returns those and the new
    ``(params, state, next view)``."""
    import contextlib

    from gaussianrenderer_tpu_torch.utils import trace

    out = {"off": {"enqueue_ms": [], "steps_per_s": []},
           "on": {"enqueue_ms": [], "steps_per_s": []}}
    j = start
    for i in range(turns):
        side = "on" if i % 4 in (1, 2) else "off"
        ctx = trace.enabled() if side == "on" else contextlib.nullcontext()
        enq = []
        core.sync(device)
        with ctx:
            t_turn = time.perf_counter()
            for _ in range(block):
                t0 = time.perf_counter()
                params, st, _ = s["step"](params, st, *s["view"](j))
                enq.append(time.perf_counter() - t0)
                j += 1
            core.sync(device)
            t_end = time.perf_counter()
        out[side]["enqueue_ms"].append(1e3 * statistics.fmean(enq))
        out[side]["steps_per_s"].append(block / (t_end - t_turn))
    return out, (params, st, j)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=0, help="profiled steps (the mix's "
                    "named_steps by default)")
    ap.add_argument("--turns", type=int, default=6)
    ap.add_argument("--block", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
    import torch

    from gaussianrenderer_tpu_torch.utils import trace

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    cell = core.cell(args.workload)
    s = setup(cell, args.seed, args.device)
    n_check = cell.traffic["checked_steps"]
    off, state_off = checked(s, n_check)
    with trace.enabled():
        on, state_on = checked(s, n_check)
    res = {"workload": args.workload, "seed": args.seed,
           "device": core.device_record(args.device, cell.chips),
           "checked_equal": off == on and same_bits(state_off, state_on),
           "checked": off}
    del state_on
    params, st = state_off
    # Warm up as the driver's set-up does: the rest of one cycle.
    for j in range(n_check, s["views"]):
        params, st, _ = s["step"](params, st, *s["view"](j))
    core.steady_host()
    res["cost"], (params, st, j) = cost(s, params, st, s["views"], args.turns, args.block,
                                        args.device)
    steps = args.steps or cell.traffic["named_steps"]
    params, st, evs = segment(s["step"], params, st, s["view"], j, steps, args.device)
    red = reduce(evs)
    res["spans"], res["metrics"] = red, metrics(red)
    if args.device == "cuda":
        params, st, dev_evs = segment(s["step"], params, st, s["view"], j + steps, steps,
                                      args.device, host=False)
        res["device_alone"] = pace(dev_evs, steps)
    # The compositor's kernels by name in the same profile, as
    # train_compositor_ms.train reads them, beside its spans' device time.
    res["compositor_kernels_ms"] = sum(e.end - e.start for e in evs if e.kind == "device"
                                       and _counts.is_train_compositor(e.name)) / 1e3 / steps
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
