"""A user fitting a capture: training steps back to back.

The mix (``benchmark/traffic/<name>.json``, ``"kind": "train_steps"``)
gives the perturbation the fit starts from (seeded Gaussian noise of
``position_noise_sigma`` on every position, ``opacity_logit_shift`` added
to every opacity logit) and the number of steps the reference follows.
The configuration gives the SH degree and the training resolution; its
``train`` section the rig of views, the loss and the optimizer. The
targets are the reference's renders of the scene file at each view, so
the program and the reference get the same inputs; their time is kept
out of ``setup_s``.

Set-up loads the scene through ``scene/io.load_scene`` (the SH bands the
file lacks are added as zeros, as 3DGS allocates them), builds one
``train.make_train_step`` step with ``make_3dgs_optimizer`` and
``l1_dssim_loss``, and drives it from the perturbed parameters through
one cycle of the views in an order drawn from the seed. Of those steps
the first ``checked_steps`` (three different views) are the ones the
reference follows: their losses, the first gradient (the optimizer's
first moment after one step, over 1 − β₁) and the parameters' change
after the last, each leaf's norm. The window goes on with the same state,
steps back to back as a fit runs them, losses kept on the card and read
at the end, one synchronize at the window's close.

A traced run then profiles the device alone over ``traced_steps`` more
steps (busy time, kernel times, the idle share against the host's clock),
and the host and the device together over ``named_steps`` steps, only to
name the idle gaps by what the host was doing.
"""

from __future__ import annotations

import gc
import json
import math
import random
import sys
import time

import torch

from benchmark import core
from benchmark.metrics import _counts
from benchmark.reference import render as R
from benchmark.reference import train as RT
from benchmark.reference.scene_io import read_scene

LEAVES = RT.LEAVES


def rig(train: dict):
    """The rig's views: (position, target) of each."""
    r = train["rig"]
    out = []
    for i in range(r["views"]):
        a = 2 * math.pi * i / r["views"]
        out.append(((r["radius"] * math.sin(a), r["heights"][i % len(r["heights"])],
                     r["radius"] * math.cos(a)), r["target"]))
    return out


def noise(shape, seed: int, device: str) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def leaf_gaps(prog: dict, ref: dict) -> float:
    """The worst leaf's |‖prog‖ − ‖ref‖| over the larger of its reference
    norm and the median leaf's; leaves whose reference norm is below a
    thousandth of the median leaf's are left out."""
    med = sorted(ref.values())[len(ref) // 2]
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref if ref[k] >= 1e-3 * med]
    return max(gaps)


def change_norms(params, params0) -> dict:
    """Each leaf's norm of ``params − params0`` over the entries finite in
    both (the scene files hold a few splats with NaN parameters)."""
    out = {}
    for k in LEAVES:
        d = getattr(params, k).detach() - getattr(params0, k).detach()
        out[k] = float(torch.linalg.vector_norm(torch.where(torch.isfinite(d), d, 0.0)))
    return out


def half_batch_loss(gt):
    """The configuration's loss over the top half of the frame only: a
    fault the check has to catch (half the batch left out)."""
    from gaussianrenderer_tpu_torch.train import render_for_training, ssim

    def loss(params, cam, target, cfg, *extra, ndc_probe=None):
        fb = render_for_training(params, cam, cfg, *extra, ndc_probe=ndc_probe)
        rows = fb.shape[1] // 2
        fb, target = fb[:, :rows], target[:, :rows]
        return 0.8 * torch.mean(torch.abs(fb - target)) + 0.2 * (1.0 - ssim(fb, target)) / 2.0

    return loss


def run(cell, *, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        fault=None) -> dict:
    import gaussianrenderer_tpu_torch as gt

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
    dpos = tr["position_noise_sigma"] * noise(truth.positions.shape, seed, device)
    params0 = truth._replace(positions=truth.positions + dpos,
                             raw_opacity=truth.raw_opacity + tr["opacity_logit_shift"])
    del truth, dpos
    views = rig(train)
    r = train["rig"]
    cams = [core.port_camera(gt, p, t, r["fov_y"], w / h, r["near"], r["far"], train["k_sigma"],
                             device) for p, t in views]
    t_ref = time.perf_counter()
    targets = reference_targets(conf, views, device)
    core.sync(device)
    reference_s = time.perf_counter() - t_ref
    order = random.Random(seed).sample(range(len(views)), len(views))

    o = train["optimizer"]
    opt = gt.make_3dgs_optimizer(
        position_lr_init=o["position_lr_init"], position_lr_final=o["position_lr_final"],
        position_lr_max_steps=o["position_lr_max_steps"], sh_lr=o["sh_lr"],
        sh_rest_div=o["sh_rest_div"], opacity_lr=o["opacity_lr"], scale_lr=o["scale_lr"],
        quat_lr=o["quat_lr"])
    loss_fn = half_batch_loss(gt) if fault == "half_batch" else gt.l1_dssim_loss
    step, _ = gt.make_train_step(rcfg, optimizer=opt, loss_fn=loss_fn)
    if fault in ("state_unchanged", "altered_loss"):
        real = step

        def step(params, st, cam, target):  # noqa: F811
            p, st2, loss = real(params, st, cam, target)
            if fault == "state_unchanged":
                return params, st2, loss
            return p, st2, loss * 1.05

    def view(j):
        v = order[j % len(order)]
        return cams[v], targets[v]

    # Set-up: one cycle of the views; the first checked_steps are compared.
    n_check = tr["checked_steps"]
    params, st = params0, opt.init(params0)
    losses, first_grad, change = [], None, None
    for j in range(len(order)):
        params, st, loss = step(params, st, *view(j))
        if j < n_check:
            losses.append(loss)
        if j == 0:
            first_grad = {k: float(torch.linalg.vector_norm(torch.nan_to_num(getattr(st.mu, k))))
                          / (1.0 - o["b1"]) for k in LEAVES}
        if j == n_check - 1:
            change = change_norms(params, params0)
    core.sync(device)
    rec = core.Record(setup_s=time.perf_counter() - t_start - reference_s)
    core.steady_host()

    # The window: steps back to back, the losses drained at the end.
    pending = []
    j = len(order)
    t_win = time.perf_counter()
    while time.perf_counter() - t_win < seconds:
        t0 = time.perf_counter()
        params, st, loss = step(params, st, *view(j))
        rec.enqueue_s.append(time.perf_counter() - t0)
        pending.append(loss)
        j += 1
    core.sync(device)
    t_end = time.perf_counter()
    rec.window_s, rec.units = t_end - t_win, j - len(order)
    failed = int((~torch.isfinite(torch.stack(pending).cpu())).sum())
    breakdown = None

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        # The device alone over the steady window: busy time and kernels.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for k in range(tr["traced_steps"]):
                params, st, loss = step(params, st, *view(j + k))
            core.sync(device)
            rec.trace_window_s = time.perf_counter() - t0
        j += tr["traced_steps"]
        red = core.reduce_profile(prof)
        rec.busy_s, rec.kernel_s = red["busy_s"], red["kernel_s"]
        rec.trace_units = tr["traced_steps"]
        # The host beside it, only to name the idle gaps.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(core.TRACED_WINDOW):
                for k in range(tr["named_steps"]):
                    with record_function("train_step"):
                        params, st, loss = step(params, st, *view(j + k))
                core.sync(device)
        breakdown = {"device_ops": red["device_ops"],
                     "idle_gaps": core.reduce_profile(prof, ("train_step",))["idle_gaps"]}
        rec.spans_ms, rec.device_ms = layer_spans(gt, rcfg, params0, opt, train, *view(0))
        # The training compositor on the first checked step's inputs.
        with profile(activities=[ProfilerActivity.CUDA]) as p1:
            step(params0, opt.init(params0), *view(0))
            core.sync(device)
        ks = core.reduce_profile(p1)["kernel_s"]
        rec.roofline.append({"view": order[0],
                             "kernel_s": core.kernel_seconds(ks, _counts.is_train_compositor),
                             "pixels": w * h, "tiles": rcfg.num_tiles})

    dev = core.device_record(device, cell.chips)
    prog = {"losses": [float(x) for x in losses], "first_grad": first_grad, "change": change}
    del params, st, params0, pending, step, loss, losses
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    ref = reference_steps(conf, tr, views, order, targets, seed, device,
                          counts=rec.roofline[0] if rec.roofline else None)
    checks = compare(prog, ref, cell.limits)
    print("detail " + json.dumps({"view": order[0], "program": prog, "reference": ref,
                                  "reference_targets_s": reference_s}), file=sys.stderr)
    failed += sum(v > lim for v, lim in checks.values())
    return {"record": rec, "checks": checks, "attempted": rec.units, "failed": failed,
            "device": dev, "breakdown": breakdown}


def layer_spans(gt, rcfg, params0, opt, train: dict, cam, target, reps: int = 3):
    """One step's layers on the first checked step's inputs, each ``reps``
    times. CUDA-event milliseconds around projection with autograd,
    tiling and gather, and the optimizer's update and apply; and the
    profiler's device milliseconds of the loss and the rest of the
    backward: the loss on the frame, forward and backward, then the
    backward from the frame to the leaves, less the training
    compositor's kernels (no other layer's time is subtracted)."""
    from torch.profiler import ProfilerActivity, profile

    from gaussianrenderer_tpu_torch.ops.compositing import (build_features,
                                                            gather_sorted_features_seg)
    from gaussianrenderer_tpu_torch.ops.projection import preprocess_gaussians
    from gaussianrenderer_tpu_torch.ops.tiling import build_sorted_instances
    from gaussianrenderer_tpu_torch.train import apply_updates, render_for_training, ssim

    def timed(fn):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1)

    lam = train["ssim_weight"]
    spans = {k: [] for k in ("projection", "tiling_gather", "optimizer")}
    device = {"loss_backward_rest": []}
    for _ in range(reps):
        leaves = gt.SceneParams(*(None if p is None else p.detach().requires_grad_(True)
                                  for p in params0))
        live = [p for p in leaves if p is not None]
        proj, ms = timed(lambda: preprocess_gaussians(
            leaves.to_scene(), cam, width=rcfg.width, height=rcfg.height, tile_w=rcfg.tile_w,
            tile_h=rcfg.tile_h, tiles_x=rcfg.tiles_x, tiles_y=rcfg.tiles_y,
            sh_degree=rcfg.sh_degree, quantize_centers=False))
        spans["projection"].append(ms)

        def tiling():
            asg = build_sorted_instances(proj, tiles_x=rcfg.tiles_x, num_tiles=rcfg.num_tiles,
                                         near=cam.near, far=cam.far)
            return gather_sorted_features_seg(build_features(proj), asg, rcfg.chunk_size)

        _, ms = timed(tiling)
        spans["tiling_gather"].append(ms)
        del proj
        fb = render_for_training(leaves, cam, rcfg)
        img = fb.detach().requires_grad_(True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            loss = ((1.0 - lam) * torch.mean(torch.abs(img - target))
                    + lam * (1.0 - ssim(img, target)) / 2.0)
            (d_img,) = torch.autograd.grad(loss, img)
            grads = torch.autograd.grad(fb, live, d_img)
            torch.cuda.synchronize()
        ks = core.reduce_profile(prof)["kernel_s"]
        rest = core.kernel_seconds(ks, lambda n: not _counts.is_train_compositor(n))
        device["loss_backward_rest"].append(1e3 * (rest or 0.0))
        it = iter(grads)
        gtree = gt.SceneParams(*(None if p is None else next(it) for p in leaves))
        _, ms = timed(lambda: apply_updates(params0, opt.update(gtree, opt.init(params0),
                                                                params0)[0]))
        spans["optimizer"].append(ms)
    return spans, device


def ref_camera(conf: dict, position, target) -> dict:
    (w, h), train = conf["train_resolution"], conf["train"]
    r = train["rig"]
    return R.look_at(position, target, r["fov_y"], w / h, r["near"], r["far"], train["k_sigma"])


def geometry(conf: dict) -> R.Geometry:
    (w, h), tile = conf["train_resolution"], conf["train"]["tile"]
    return R.Geometry(w, h, tile, tile)


def read_params(conf: dict, device: str) -> dict:
    return {k: torch.from_numpy(v).to(device)
            for k, v in read_scene(conf["scene_path"], conf["sh_degree"]).items()}


def reference_targets(conf: dict, views, device: str) -> list:
    """The reference's frame of the scene file at each view: the targets."""
    scene = R.activate(read_params(conf, device))
    return [R.render(scene, ref_camera(conf, p, t), geometry(conf), conf["sh_degree"],
                     round_centers=False) for p, t in views]


def reference_steps(conf, tr, views, order, targets, seed, device, prec=R.FP32,
                    counts=None) -> dict:
    """The reference's first ``checked_steps`` steps from the same start:
    its losses, first gradient's and change's leaf norms. With
    ``counts`` (a dict), the work of the first step's frame joins it."""
    train = conf["train"]
    params = read_params(conf, device)
    params["positions"] = params["positions"] + tr["position_noise_sigma"] * noise(
        params["positions"].shape, seed, device)
    params["raw_opacity"] = params["raw_opacity"] + tr["opacity_logit_shift"]
    seq = [(ref_camera(conf, *views[order[j]]), targets[order[j]])
           for j in range(tr["checked_steps"])]
    if counts is not None:
        c = {}
        R.render(R.activate(params), seq[0][0], geometry(conf), conf["sh_degree"],
                 round_centers=False, counts=c)
        counts.update(c)
    out = RT.train_steps(params, seq, geometry(conf), conf["sh_degree"], train["optimizer"],
                         prec)
    return {
        "losses": out["losses"],
        "first_grad": RT.leaf_norms(out["first_grads"]),
        "change": RT.leaf_norms({k: out["params"][k] - params[k] for k in LEAVES}),
    }


def compare(prog: dict, ref: dict, limits: dict) -> dict:
    """The numbers compared, each beside its limit: the first step's
    relative loss gap and the worst of the checked steps', the first
    gradient's and the change's leaf-norm gaps."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    return {
        "first_loss_rel_gap": (gaps[0], limits["first_loss_rel_gap"]["limit"]),
        "loss_rel_gap": (max(gaps), limits["loss_rel_gap"]["limit"]),
        "grad_norm_gap": (leaf_gaps(prog["first_grad"], ref["first_grad"]),
                          limits["grad_norm_gap"]["limit"]),
        "change_norm_gap": (leaf_gaps(prog["change"], ref["change"]),
                            limits["change_norm_gap"]["limit"]),
    }


def control(cell, *, seed: int, device: str, prec: R.Precision) -> dict:
    """The reference computed in ``prec``, put in the program's place for
    the checked steps of seed ``seed``: its numbers."""
    conf, tr = cell.config, cell.traffic
    views = rig(conf["train"])
    order = random.Random(seed).sample(range(len(views)), len(views))
    targets = reference_targets(conf, views, device)
    low = reference_steps(conf, tr, views, order, targets, seed, device, prec=prec)
    ref = reference_steps(conf, tr, views, order, targets, seed, device)
    return {k: v for k, (v, _) in compare(low, ref, cell.limits).items()}
