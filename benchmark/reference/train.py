"""Plain PyTorch reference of one 3DGS training step.

The step renders the trainable parameters through :mod:`render` with
continuous centres, takes the photometric loss of Kerbl et al. 2023,

    (1 − λ)·L1 + λ·(1 − SSIM)/2,   λ = 0.2,

with SSIM over an 11×11 Gaussian window of σ 1.5 (the pixels with a
whole window), back-propagates it with autograd, and applies Adam with
the 3DGS per-group rates: bias-corrected moments, ``m̂ / (√v̂ + ε)``, the
position rate decayed exponentially over the run, and the SH bands above
the first divided by a constant. The frame's gradient is taken tile
group by tile group (the composite of a group is recomputed with
autograd), so a step fits in memory at the cells' sizes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark.reference import render as R

LEAVES = ("positions", "sh", "raw_opacity", "raw_scales", "quats")


def gauss_window(size: int, sigma: float, dtype, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64) - (size - 1) / 2
    w = torch.exp(-x * x / (2 * sigma * sigma))
    return (w / w.sum()).to(dtype=dtype, device=device)


def ssim(a: torch.Tensor, b: torch.Tensor, size: int = 11, sigma: float = 1.5,
         prec: R.Precision = R.FP32) -> torch.Tensor:
    """Mean SSIM of two (3, H, W) images in [0, 1] (Wang et al. 2004)."""
    win = prec.operand(gauss_window(size, sigma, a.dtype, a.device))
    kh = win.reshape(1, 1, size, 1).expand(3, 1, size, 1)
    kw = win.reshape(1, 1, 1, size).expand(3, 1, 1, size)
    op = prec.operand

    def blur(x):
        x = torch.nn.functional.conv2d(op(x[None]), kh, groups=3)
        return torch.nn.functional.conv2d(op(x), kw, groups=3)[0]

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a * mu_a
    var_b = blur(b * b) - mu_b * mu_b
    cov = blur(a * b) - mu_a * mu_b
    return (((2 * mu_a * mu_b + c1) * (2 * cov + c2))
            / ((mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))).mean()


def photometric_loss(img: torch.Tensor, target: torch.Tensor, lam: float = 0.2,
                     prec: R.Precision = R.FP32) -> torch.Tensor:
    return (1 - lam) * (img - target).abs().mean() + lam * (1 - ssim(img, target, prec=prec)) / 2


class Adam3DGS:
    """Adam with the 3DGS rates: ``rates`` per leaf, ``positions`` as
    ``(init, final, steps)`` decayed as init·(final/init)^(t/steps)."""

    def __init__(self, opt: dict):
        self.opt = opt

    def rate(self, name: str, count: int) -> float:
        o = self.opt
        if name == "positions":
            init, final, steps = o["position_lr_init"], o["position_lr_final"], o[
                "position_lr_max_steps"]
            return max(init * (final / init) ** (count / steps), final)
        return {"sh": o["sh_lr"], "raw_opacity": o["opacity_lr"],
                "raw_scales": o["scale_lr"], "quats": o["quat_lr"]}[name]

    def init(self, params: dict) -> dict:
        return {"count": 0, "m": {k: torch.zeros_like(v) for k, v in params.items()},
                "v": {k: torch.zeros_like(v) for k, v in params.items()}}

    def step(self, params: dict, grads: dict, state: dict) -> dict:
        o, t = self.opt, state["count"] + 1
        b1, b2 = o["b1"], o["b2"]
        out = {}
        for k, p in params.items():
            g = grads[k]
            m = state["m"][k] = b1 * state["m"][k] + (1 - b1) * g
            v = state["v"][k] = b2 * state["v"][k] + (1 - b2) * g * g
            u = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + o["eps"])
            u = u * self.rate(k, state["count"])
            if k == "sh":
                u = torch.cat([u[:, :3], u[:, 3:] / o["sh_rest_div"]], 1)
            out[k] = p - u
        state["count"] = t
        return out


def tile_groups(count: torch.Tensor, lanes: int):
    """Consecutive tiles in groups of about ``lanes`` instances (a tile
    with more makes a group of its own), which bounds what autograd keeps
    of one group's composite."""
    cum = torch.cumsum(count, 0)
    cut = torch.div(cum - count, lanes, rounding_mode="floor")
    edges = torch.nonzero(torch.diff(cut)).squeeze(1) + 1
    bounds = [0] + edges.tolist() + [count.numel()]
    dev = count.device
    return [torch.arange(a, b, device=dev) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def loss_and_grads(params: dict, cam: dict, target: torch.Tensor, geo: R.Geometry,
                   sh_degree: int, prec: R.Precision = R.FP32,
                   group_lanes: int = 1 << 18) -> tuple:
    """(loss, {leaf: gradient}) of one view, in ``prec``."""
    with prec.active():
        leaves = {k: v.detach().to(prec.dtype).requires_grad_(True) for k, v in params.items()}
        proj = R.project_for_gradients(leaves, cam, geo.width, geo.height, sh_degree, prec)
        inst = R.tile_instances(proj, geo.tile_w, geo.tile_h, geo.tiles_x, geo.tiles_y)
        feat = proj.feat.detach().requires_grad_(True)
        tiles = torch.arange(geo.tiles_x * geo.tiles_y, device=feat.device)
        with torch.no_grad():
            blocks = torch.cat([R.composite(feat, proj.box, inst, geo, tiles[i:i + 512], prec)
                                for i in range(0, tiles.numel(), 512)])
        img = R.assemble(blocks, tiles, geo).detach().requires_grad_(True)
        loss = photometric_loss(img, target.to(prec.dtype), prec=prec)
        (d_img,) = torch.autograd.grad(loss, img)
        # The image's gradient as tile blocks, then each group's composite again.
        pad = d_img.new_zeros((3, geo.tiles_y * geo.tile_h, geo.tiles_x * geo.tile_w))
        pad[:, :geo.height, :geo.width] = d_img
        d_blocks = pad.reshape(3, geo.tiles_y, geo.tile_h, geo.tiles_x, geo.tile_w)
        d_blocks = d_blocks.permute(1, 3, 0, 2, 4).reshape(-1, 3, geo.tile_h * geo.tile_w)
        for group in tile_groups(inst.tile_count, group_lanes):
            out = R.composite(feat, proj.box, inst, geo, group, prec)
            out.backward(d_blocks[group])
        grad_feat = feat.grad if feat.grad is not None else torch.zeros_like(feat)
        grads = torch.autograd.grad(proj.feat, list(leaves.values()), grad_feat,
                                    allow_unused=True)
    return loss.detach().to(torch.float32), {
        k: (torch.zeros_like(v) if g is None else g.detach())
        for (k, v), g in zip(leaves.items(), grads)}


def train_steps(params: dict, views: List[tuple], geo: R.Geometry, sh_degree: int,
                opt: dict, prec: R.Precision = R.FP32) -> Dict[str, object]:
    """The first ``len(views)`` steps from ``params``: their losses, the
    first step's gradients and the parameters after the last step."""
    adam = Adam3DGS(opt)
    state = adam.init(params)
    losses, first_grads = [], None
    for cam, target in views:
        loss, grads = loss_and_grads(params, cam, target, geo, sh_degree, prec)
        if first_grads is None:
            first_grads = {k: g.to(torch.float32) for k, g in grads.items()}
        with prec.active():
            params = adam.step({k: v.to(prec.dtype) for k, v in params.items()}, grads, state)
        losses.append(float(loss))
    return {"losses": losses, "first_grads": first_grads,
            "params": {k: v.to(torch.float32) for k, v in params.items()}}


def leaf_norms(tree: Dict[str, torch.Tensor], finite: Optional[dict] = None) -> Dict[str, float]:
    """Each leaf's L2 norm over its entries that are finite (and, with
    ``finite``, finite in that tree too)."""
    out = {}
    for k, v in tree.items():
        ok = torch.isfinite(v) if finite is None else torch.isfinite(v) & finite[k]
        out[k] = float(torch.linalg.vector_norm(torch.where(ok, v, torch.zeros_like(v))))
    return out
