"""Gaussian-splat optimization (PyTorch port of ``train.py``).

* :class:`SceneParams` — trainable pre-activation parameters (logit
  opacity, log scales), the PLY convention, so a trained scene converts
  back with :meth:`SceneParams.to_scene`.
* :func:`render_for_training` — the differentiable render: the tile-sort
  path with ``compositor="diff"`` and continuous centers, whose
  compositor is the training kernels' forward and backward on
  128-pixel-multiple tiles (ops/tile_train.py).
* :func:`mse_loss`, :func:`ssim`, :func:`l1_dssim_loss` — the losses
  (L1 + 0.2·D-SSIM is the standard 3DGS photometric loss).
* :func:`make_optimizer` / :func:`make_3dgs_optimizer` — Adam with
  optax's arithmetic, the latter with the 3DGS per-group rates, the
  decayed position rate and the higher SH bands' updates divided by 20.
* :func:`make_train_step` — ``(params, opt_state, cam, target[,
  time_value]) → (params, opt_state, loss)``; :func:`_make_step_fn` is
  its body, and with ``densify=True`` the step also folds the view-space
  gradient into a :class:`DensifyState`.
* :func:`densify_step` — one adaptive-density-control episode under a
  fixed splat budget: pruned slots are refilled with samples of the
  highest-gradient donors, on the device with no host wait.
* :func:`fit_scene` — the training loop as one call (densification,
  opacity resets, SH warm-up, checkpoints, resume); :func:`evaluate`,
  :func:`load_views` / :func:`dataset_image_shape` for ``poses.json``
  datasets, :func:`save_checkpoint` / :func:`load_checkpoint`.
* Several devices: :func:`make_multichip_train_step` (each rank trains
  its block of splats on its strip of the frame, ``parallel.multichip``),
  :func:`pad_params_for_mesh`, :func:`pad_target_for_mesh`, and
  ``fit_scene(mesh=...)``.

The optimizer is functional, like optax: ``opt.init(params)`` makes the
state, ``opt.update(grads, state)`` returns the updates and the new state,
and :func:`apply_updates` adds the updates to new parameter tensors.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from gaussianrenderer_tpu_torch._device import resolve_device
from gaussianrenderer_tpu_torch.config import RenderConfig
from gaussianrenderer_tpu_torch.ops.projection import preprocess_gaussians, slice_spacetime
from gaussianrenderer_tpu_torch.render import _render_impl
from gaussianrenderer_tpu_torch.scene.camera import CameraParams
from gaussianrenderer_tpu_torch.scene.gaussians import GaussianScene


class SceneParams(NamedTuple):
    """Trainable pre-activation scene parameters. ``time_params`` is the
    optional 4D leaf ((N, 2) temporal opacity or (N, 5) with linear
    motion), trained like the others when present."""

    positions: torch.Tensor  # (N, 3)
    sh: torch.Tensor  # (N, 3*(deg+1)^2)
    raw_opacity: torch.Tensor  # (N,) logit-space
    raw_scales: torch.Tensor  # (N, 3) log-space
    quats: torch.Tensor  # (N, 4) unnormalized
    time_params: Optional[torch.Tensor] = None  # (N, 2) or (N, 5)

    @classmethod
    def from_scene(cls, scene: GaussianScene) -> "SceneParams":
        eps = 1e-6
        op = torch.clamp(scene.opacity, eps, 1.0 - eps)
        return cls(
            positions=scene.positions,
            sh=scene.sh,
            raw_opacity=torch.log(op / (1.0 - op)),
            raw_scales=torch.log(torch.clamp_min(scene.scales, 1e-30)),
            quats=scene.quats,
            time_params=scene.time_params,
        )

    def to_scene(self, time_params: Optional[torch.Tensor] = None) -> GaussianScene:
        return GaussianScene(
            positions=self.positions,
            sh=self.sh,
            opacity=torch.sigmoid(_finite_grad(self.raw_opacity)),
            scales=torch.exp(_finite_grad(self.raw_scales)),
            quats=self.quats,
            time_params=self.time_params if time_params is None else time_params,
        )


def _finite_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, passing no gradient to its non-finite entries: a NaN
    or infinite logit makes its activation's derivative non-finite, and the
    zero gradient of such a splat (it is never valid) would become NaN."""
    return torch.where(torch.isfinite(x), x, x.detach())


def _training_config(cfg: RenderConfig) -> RenderConfig:
    return dataclasses.replace(cfg, compositor="diff", quantize_centers=False)


def render_for_training(
    params: SceneParams,
    cam: CameraParams,
    cfg: RenderConfig,
    time_value=None,
    ndc_probe: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable forward render of trainable parameters, at an
    optional time for spacetime scenes. ``ndc_probe``: optional (2, N)
    zeros whose gradient is the view-space center gradient."""
    fb, _ = _render_impl(params.to_scene(), cam, _training_config(cfg), time_value,
                         ndc_probe=ndc_probe)
    return fb


def mse_loss(params, cam, target, cfg, time_value=None, ndc_probe=None):
    fb = render_for_training(params, cam, cfg, time_value, ndc_probe)
    return torch.mean((fb - target) ** 2)


def _gauss_window(size: int = 11, sigma: float = 1.5, device="cpu") -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    w = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return w / torch.sum(w)


def _blur_hw(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of a planar (3, H, W) image: two rank-1
    depthwise convolutions, VALID. In full fp32: var = blur(a²) − μ²
    cancels ~0.25-scale terms down to ~1e-4 variances, which TF32 (the
    card's default for fp32 convolutions) would drown, so it is off here.
    cuDNN may only pick deterministic algorithms here (its default may
    pick a backward that adds in a different order every run), so a
    training step gives the same gradient every time; the setting holds
    for these two calls alone, not for the process."""
    size = window.shape[0]
    kh = window.reshape(1, 1, size, 1).expand(3, 1, size, 1)
    kw = window.reshape(1, 1, 1, size).expand(3, 1, 1, size)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=True, allow_tf32=False):
        x = torch.nn.functional.conv2d(img[None], kh, groups=3)
        x = torch.nn.functional.conv2d(x, kw, groups=3)
    return x[0]


def ssim(a, b, window_size: int = 11, sigma: float = 1.5, peak: float = 1.0):
    """Mean SSIM between two planar (3, H, W) images (Wang et al. 2004,
    the 11×11 σ=1.5 Gaussian window every 3DGS trainer uses), over the
    pixels with a full window."""
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    win = _gauss_window(window_size, sigma, device=a.device)
    mu_a = _blur_hw(a, win)
    mu_b = _blur_hw(b, win)
    var_a = _blur_hw(a * a, win) - mu_a * mu_a
    var_b = _blur_hw(b * b, win) - mu_b * mu_b
    cov = _blur_hw(a * b, win) - mu_a * mu_b
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    return torch.mean(num / den)


def l1_dssim_loss(params, cam, target, cfg, time_value=None, ndc_probe=None,
                  ssim_weight: float = 0.2):
    """(1−λ)·L1 + λ·(1−SSIM)/2, λ = 0.2 (Kerbl et al. 2023, §5)."""
    fb = render_for_training(params, cam, cfg, time_value, ndc_probe)
    l1 = torch.mean(torch.abs(fb - target))
    dssim = (1.0 - ssim(fb, target)) / 2.0
    return (1.0 - ssim_weight) * l1 + ssim_weight * dssim


# ------------------------------------------------------------------ Adam
Rate = Union[float, Callable[[torch.Tensor], torch.Tensor]]
#: Adam's moment decays (optax.adam's defaults; every optimizer here uses them).
ADAM_B1 = 0.9
ADAM_B2 = 0.999


class AdamState(NamedTuple):
    """Adam's state: steps taken, and the first and second moments as
    SceneParams-shaped leaves (None where a leaf is None), so each
    moment keeps the (N, …) row layout of its parameter."""

    count: torch.Tensor  # () int32
    mu: SceneParams
    nu: SceneParams


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam with optax's arithmetic (``optax.adam``: bias-corrected
    moments, ``m̂ / (√v̂ + eps)``, then ``−rate``), a rate per SceneParams
    leaf (a float, or a schedule of the pre-increment step count), and
    the SH leaf's columns after the first three (the DC term) scaled by
    ``1/sh_rest_div`` after the rate."""

    rates: Dict[str, Rate]
    eps: float = 1e-8
    sh_rest_div: Optional[float] = None

    def init(self, params: SceneParams) -> AdamState:
        zeros = SceneParams(*(None if p is None else torch.zeros_like(p) for p in params))
        dev = params.positions.device
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev), zeros, zeros)

    def update(self, grads: SceneParams, state: AdamState, params=None):
        """Returns ``(updates, new_state)``; updates are SceneParams."""
        del params
        count = state.count + 1
        f32 = torch.float32
        bc1 = 1.0 - torch.pow(torch.tensor(ADAM_B1, dtype=f32, device=count.device),
                              count.to(f32))
        bc2 = 1.0 - torch.pow(torch.tensor(ADAM_B2, dtype=f32, device=count.device),
                              count.to(f32))
        mus, nus, ups = [], [], []
        for name, g, m, v in zip(SceneParams._fields, grads, state.mu, state.nu):
            if g is None:
                mus.append(None)
                nus.append(None)
                ups.append(None)
                continue
            m = (1.0 - ADAM_B1) * g + ADAM_B1 * m
            v = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            rate = self.rates[name]
            step = rate(state.count) if callable(rate) else rate
            u = (-step) * u
            if name == "sh" and self.sh_rest_div is not None and u.shape[1] > 3:
                u = torch.cat([u[:, :3], u[:, 3:] * (1.0 / self.sh_rest_div)], dim=1)
            mus.append(m)
            nus.append(v)
            ups.append(u)
        return SceneParams(*ups), AdamState(count, SceneParams(*mus), SceneParams(*nus))


def apply_updates(params: SceneParams, updates: SceneParams) -> SceneParams:
    return SceneParams(*(
        None if p is None else (p + u).to(p.dtype) for p, u in zip(params, updates)
    ))


def make_optimizer(lr: float = 1e-2) -> Adam:
    """``optax.adam(lr)`` on every leaf."""
    return Adam(rates={name: lr for name in SceneParams._fields})


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      end_value: Optional[float] = None):
    """``optax.exponential_decay`` (continuous, no delay): ``init ·
    rate^(count / steps)``, bounded by ``end_value``, in f32."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        p = count.to(torch.float32) / transition_steps
        decayed = init_value * torch.pow(
            torch.tensor(decay_rate, dtype=torch.float32, device=count.device), p
        )
        value = torch.where(count <= 0, torch.tensor(init_value, device=count.device),
                            decayed)
        if end_value is not None:
            bound = torch.maximum if decay_rate < 1.0 else torch.minimum
            value = bound(value, torch.tensor(end_value, device=count.device))
        return value.to(torch.float32)

    return schedule


def make_3dgs_optimizer(
    scene_extent: float = 1.0,
    *,
    position_lr_init: float = 1.6e-4,
    position_lr_final: float = 1.6e-6,
    position_lr_max_steps: int = 30_000,
    sh_lr: float = 2.5e-3,
    sh_rest_div: float = 20.0,
    opacity_lr: float = 5e-2,
    scale_lr: float = 5e-3,
    quat_lr: float = 1e-3,
    time_lr: float = 1e-3,
) -> Adam:
    """The standard 3DGS per-group schedule (Kerbl et al. 2023 defaults):
    positions at ``position_lr_init·scene_extent`` decayed exponentially
    to ``position_lr_final·scene_extent`` over ``position_lr_max_steps``;
    SH DC at ``sh_lr`` with the higher bands ÷``sh_rest_div``;
    opacity, scale, rotation and the 4D leaf at their rates; eps 1e-15."""
    pos = exponential_decay(
        position_lr_init * scene_extent, position_lr_max_steps,
        position_lr_final / position_lr_init, position_lr_final * scene_extent,
    )
    rates = dict(positions=pos, sh=sh_lr, raw_opacity=opacity_lr,
                 raw_scales=scale_lr, quats=quat_lr, time_params=time_lr)
    return Adam(rates=rates, eps=1e-15, sh_rest_div=sh_rest_div)


def reset_opacity(params: SceneParams, opt_state: Optional[AdamState] = None,
                  ceiling: float = 0.01):
    """The 3DGS periodic opacity reset: clamp every opacity to at most
    ``ceiling``; with ``opt_state`` the opacity moments are zeroed too.
    Returns ``params`` or ``(params, opt_state)``."""
    eps = 1e-6
    c = min(max(ceiling, eps), 1.0 - eps)
    raw = params.raw_opacity
    raw_ceiling = torch.log(torch.tensor(c / (1.0 - c), dtype=torch.float32,
                                         device=raw.device))
    params = params._replace(raw_opacity=torch.minimum(raw, raw_ceiling))
    if opt_state is None:
        return params
    zero = torch.zeros_like(params.raw_opacity)
    return params, opt_state._replace(
        mu=opt_state.mu._replace(raw_opacity=zero),
        nu=opt_state.nu._replace(raw_opacity=zero),
    )


def _emission_terms(scene_like: GaussianScene, cam: CameraParams, tcfg: RenderConfig,
                    time_value=None):
    """The training path's emission for one view: ``(needed, visible)``,
    ``needed`` the Σ valid·w·h tile-rect total as a 0-d int64 tensor (the
    path emits each valid splat's whole rect, so it equals the instances
    of the view) and ``visible`` ``proj.valid``, upstream 3DGS's
    ``radii > 0`` visibility. A no-grad re-projection of ``scene_like``
    with the training config; the port has no static instance capacity,
    so nothing compares ``needed`` with one."""
    with torch.no_grad():
        s, extra = slice_spacetime(scene_like, time_value)
        proj = preprocess_gaussians(
            s, cam, width=tcfg.width, height=tcfg.height, tile_w=tcfg.tile_w,
            tile_h=tcfg.tile_h, tiles_x=tcfg.tiles_x, tiles_y=tcfg.tiles_y,
            sh_degree=tcfg.sh_degree, extra_opacity_scale=extra,
            quantize_centers=tcfg.quantize_centers, ewa_dilation=tcfg.ewa_dilation,
            ewa_compensate=tcfg.ewa_compensate,
        )
        w = (proj.tile_max[:, 0] - proj.tile_min[:, 0] + 1).to(torch.int64)
        h = (proj.tile_max[:, 1] - proj.tile_min[:, 1] + 1).to(torch.int64)
        needed = torch.where(proj.valid, w * h, 0).sum()
    return needed, proj.valid


def _make_step_fn(cfg: RenderConfig, optimizer: "Adam", loss_fn, *, timed: bool,
                  densify: bool):
    """The train-step body shared by :func:`make_train_step` and
    :func:`fit_scene`.

    ``step(params, opt_state, [dstate,] cam, target[, time_value])``:
    ``densify=True`` takes and returns a :class:`DensifyState` and
    differentiates the loss with respect to an all-zeros (2, N) NDC probe
    as well, whose gradient is the view-space positional gradient
    adaptive density control keys on; it returns ``(params, opt_state,
    dstate, loss, needed)`` with ``needed`` from :func:`_emission_terms`
    on the pre-update parameters. Without it the step returns
    ``(params, opt_state, loss)``."""
    n_in = 2 + int(timed) + int(densify)

    def step(params: SceneParams, opt_state: AdamState, *rest):
        if len(rest) != n_in:
            raise TypeError(
                ("make_train_step" if not densify else "_make_step_fn(densify=True)")
                + ": the step takes (params, opt_state, "
                + ("dstate, " if densify else "") + "cam, target"
                + (", time_value)" if timed else ")")
            )
        if densify:
            dstate, rest = rest[0], rest[1:]
        cam, target, extra = rest[0], rest[1], tuple(rest[2:])
        leaves = SceneParams(*(
            None if p is None else p.detach().requires_grad_(True) for p in params
        ))
        live = [p for p in leaves if p is not None]
        if densify:
            probe = torch.zeros((2, params.positions.shape[0]), dtype=torch.float32,
                                device=params.positions.device, requires_grad=True)
            loss = loss_fn(leaves, cam, target, cfg, *extra, ndc_probe=probe)
            live.append(probe)
        else:
            loss = loss_fn(leaves, cam, target, cfg, *extra)
        grads = iter(torch.autograd.grad(loss, live, allow_unused=True))
        grads_tree = SceneParams(*(
            None if p is None else _or_zeros(next(grads), p) for p in leaves
        ))
        with torch.no_grad():
            if densify:
                view_grads = _or_zeros(next(grads), probe)
                needed, visible = _emission_terms(
                    params.to_scene(), cam, _training_config(cfg),
                    extra[0] if extra else None,
                )
            updates, opt_state = optimizer.update(grads_tree, opt_state, params)
            params = apply_updates(SceneParams(*(
                None if p is None else p.detach() for p in params)), updates)
            if densify:
                dstate = accumulate_densify_stats(dstate, view_grads, visible)
                return params, opt_state, dstate, loss.detach(), needed
        return params, opt_state, loss.detach()

    return step


def make_train_step(cfg: RenderConfig, optimizer: Optional[Adam] = None,
                    loss_fn=None, timed: bool = False):
    """A single-device train step against a target frame; returns
    ``(step, optimizer)``.

    ``step(params, opt_state, cam, target) → (params, opt_state, loss)``,
    with a fifth ``time_value`` operand when ``timed`` (spacetime scenes
    fit to time-stamped targets). ``loss_fn(params, cam, target, cfg[,
    time_value], ndc_probe=None)`` defaults to :func:`mse_loss`; pass
    :func:`l1_dssim_loss` for the 3DGS loss. The step returns new
    parameter tensors (the inputs are not modified) and the loss as a
    0-d tensor."""
    optimizer = optimizer or make_optimizer()
    loss_fn = loss_fn or mse_loss
    return _make_step_fn(cfg, optimizer, loss_fn, timed=timed, densify=False), optimizer


def _or_zeros(g, p):
    """A leaf the loss does not reach (``allow_unused``) has gradient 0."""
    return torch.zeros_like(p) if g is None else g


# --------------------------------------------------------------- multi-device
def make_multichip_train_step(cfg: RenderConfig, mesh, optimizer: Optional[Adam] = None,
                              strip_bounds=None, with_stats: bool = False):
    """The mesh-parallel train step; returns ``(step, optimizer)``.

    Every rank calls ``step(params, opt_state, cam, target) → (params,
    opt_state, loss[, overflow])`` with its own shard of the parameters
    (rows ``[rank·N/D, (rank+1)·N/D)`` of :func:`pad_params_for_mesh`'s
    output), its own Adam state, the camera, and the whole target padded
    by :func:`pad_target_for_mesh`. Each rank renders its strip through
    the differentiable multi-device path (``parallel.multichip``, the
    ``gather32`` exchange), takes the squared error over the strip rows
    it owns and backpropagates that error alone: the all-gather's
    backward sums every rank's feature gradients onto the owning rank, so
    each shard gets its rows of the single device's MSE gradient. The
    returned loss is ``all_reduce(Σ error) / (3·H·W)``, the same on every
    rank, and carries no gradient. Adam updates each shard locally.

    ``strip_bounds`` (``parallel.balance_strips_for_scene``) balances the
    strips as in ``render_frame_multichip``; without it ``cfg.tiles_y``
    must divide by D. ``with_stats`` adds ``overflow``, always False: the
    port has no instance capacity to truncate."""
    import torch.distributed as dist

    from gaussianrenderer_tpu_torch.parallel.multichip import (
        _all_reduce,
        _strip_render,
        strip_geometry,
    )

    optimizer = optimizer or make_optimizer()
    d = mesh.size
    if strip_bounds is None:
        diffs = None
        if cfg.tiles_y % d != 0:
            raise ValueError(
                f"tiles_y={cfg.tiles_y} must be divisible by the mesh "
                f"size {d} (or pass balanced strip_bounds)"
            )
    else:
        strip_bounds = tuple(int(b) for b in strip_bounds)
        diffs, rows_max = strip_geometry(strip_bounds, d, cfg.tiles_y)
    train_cfg = _training_config(cfg)
    total_px = 3 * cfg.height * cfg.width

    def step(params: SceneParams, opt_state: AdamState, cam: CameraParams, target):
        leaves = SceneParams(*(
            None if p is None else p.detach().requires_grad_(True) for p in params
        ))
        fb_strip, overflow, _ = _strip_render(
            leaves.to_scene(), cam, train_cfg, mesh, "diff", strip_bounds=strip_bounds)
        h = fb_strip.shape[1]
        rows = torch.arange(h, device=fb_strip.device)
        if strip_bounds is None:
            row0 = mesh.rank * h
            rows_valid = (row0 + rows) < cfg.height
        else:
            row0 = strip_bounds[mesh.rank] * cfg.tile_h
            rows_valid = (rows < diffs[mesh.rank] * cfg.tile_h) & ((row0 + rows) < cfg.height)
            need_h = (cfg.tiles_y + rows_max) * cfg.tile_h
            target = torch.nn.functional.pad(target, (0, 0, 0, need_h - target.shape[1]))
        target_local = target[:, row0:row0 + h, :]
        err = torch.sum((fb_strip - target_local) ** 2 * rows_valid[None, :, None])
        live = [p for p in leaves if p is not None]
        grads = iter(torch.autograd.grad(err / total_px, live, allow_unused=True))
        grads_tree = SceneParams(*(
            None if p is None else _or_zeros(next(grads), p) for p in leaves
        ))
        with torch.no_grad():
            loss = _all_reduce(mesh, err.detach(), dist.ReduceOp.SUM) / total_px
            updates, opt_state = optimizer.update(grads_tree, opt_state, params)
            params = apply_updates(SceneParams(*(
                None if p is None else p.detach() for p in params)), updates)
        if with_stats:
            return params, opt_state, loss, overflow
        return params, opt_state, loss

    return step, optimizer


def pad_target_for_mesh(target: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """A (3, H, W) target with its rows padded to the whole tile grid, so
    strips slice it at tile rows; the pad rows are masked out of the loss."""
    return torch.nn.functional.pad(target, (0, 0, 0, cfg.tiles_y * cfg.tile_h - target.shape[1]))


#: Pad-row values of :func:`pad_params_for_mesh`: inert splats.
_MESH_PAD_FILL = {"raw_opacity": -30.0, "raw_scales": -20.0}


def pad_params_for_mesh(params: SceneParams, multiple: int) -> SceneParams:
    """Pad N up to a multiple of the mesh size with inert splats:
    raw_opacity −30 (sigmoid ≈ 9e−14, below every alpha threshold, so they
    render nothing and get exactly zero gradient, and Adam leaves them as
    they are), raw_scales −20, unit quaternions and zeros elsewhere. A
    zero pad would not do: raw opacity 0 is opacity 0.5."""
    n = params.positions.shape[0]
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return params

    def pad(name, x):
        if x is None:
            return None
        fill = x.new_full((n_pad - n,) + tuple(x.shape[1:]), _MESH_PAD_FILL.get(name, 0.0))
        if name == "quats":
            fill[:, 0] = 1.0
        return torch.cat([x, fill])

    return SceneParams(*(pad(k, v) for k, v in params._asdict().items()))


def _mesh_gather(tree, mesh, n: int):
    """A SceneParams-like tree of row shards → the whole rows ``[0, n)``
    on every rank."""
    from gaussianrenderer_tpu_torch.parallel.multichip import gather_rows

    with torch.no_grad():
        return type(tree)(*(None if x is None else gather_rows(mesh, x)[:n] for x in tree))


def _mesh_shard(tree, mesh):
    from gaussianrenderer_tpu_torch.parallel.multichip import _shard_rows

    return type(tree)(*(_shard_rows(x, mesh) for x in tree))


# ------------------------------------------------- adaptive density control
class DensifyState(NamedTuple):
    """Accumulated densification statistics (leading dim N): the 3DGS
    adaptive-density-control bookkeeping. ``grad_accum`` sums the norm of
    the view-space positional gradient (the gradient of the zero NDC
    probe, upstream's ``means2D`` gradient, so the paper's 2e-4 threshold
    keeps its meaning) and ``denom`` counts the steps a splat projected."""

    grad_accum: torch.Tensor  # (N,) f32
    denom: torch.Tensor  # (N,) f32
    steps: torch.Tensor  # () int32

    @classmethod
    def zero(cls, n: int, device="cuda") -> "DensifyState":
        dev = resolve_device(device)
        return cls(
            grad_accum=torch.zeros((n,), dtype=torch.float32, device=dev),
            denom=torch.zeros((n,), dtype=torch.float32, device=dev),
            steps=torch.zeros((), dtype=torch.int32, device=dev),
        )


def accumulate_densify_stats(state: DensifyState, view_grads: torch.Tensor,
                             visible: Optional[torch.Tensor] = None) -> DensifyState:
    """Fold one step's (2, N) view-space gradient into ``state``.
    ``visible`` is the (N,) projected mask (upstream's ``update_filter``);
    without it a splat counts as seen where its gradient is nonzero."""
    gx, gy = view_grads[0], view_grads[1]
    norm = torch.sqrt(gx * gx + gy * gy)
    seen = (norm > 0.0) if visible is None else visible
    return DensifyState(
        grad_accum=state.grad_accum + norm,
        denom=state.denom + seen.to(torch.float32),
        steps=state.steps + 1,
    )


def _densify_eps(seed: int, n: int, device) -> torch.Tensor:
    """The (n, 3) standard-normal sample offsets of a densify episode,
    from a ``torch.Generator`` on ``device`` seeded with ``seed``. The
    JAX package draws ``jax.random.normal(PRNGKey(seed))``, which this
    does not reproduce: the same seed gives other samples."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn((n, 3), generator=gen, device=device, dtype=torch.float32)


def _nanquantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.nanquantile(x, q)`` (linear interpolation) of a 1-D f32
    tensor, from one sort (NaN sorts last): the same arithmetic in the same
    order, with no size limit (``torch.nanquantile`` refuses inputs above
    2^24 elements) and no host wait."""
    s = torch.sort(x).values
    counts = (~torch.isnan(x)).sum().to(torch.float32)
    pos = (counts - 1.0) * q
    low, high = torch.floor(pos), torch.ceil(pos)
    high_weight = pos - low
    low_weight = 1.0 - high_weight
    low = torch.clamp_min(torch.minimum(low, counts - 1.0), 0.0).to(torch.int64)
    high = torch.clamp_min(torch.minimum(high, counts - 1.0), 0.0).to(torch.int64)
    # take(), not s[low]: indexing by a 0-d tensor reads it on the host.
    return torch.take(s, low) * low_weight + torch.take(s, high) * high_weight


def _rows(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1))


def densify_step(
    params: SceneParams,
    opt_state: AdamState,
    state: DensifyState,
    *,
    grad_threshold: float = 2e-4,
    prune_opacity: float = 5e-3,
    split_scale_pct: float = 0.75,
    prune_scale: Optional[float] = None,
    seed: int = 0,
):
    """One adaptive-density-control episode under a fixed splat budget N.

    Splats below ``prune_opacity`` (and, with ``prune_scale``, those whose
    largest world-space scale exceeds it) are dead slots. Donors are the
    live splats whose mean view-space gradient exceeds
    ``grad_threshold``, ranked by descending score; dead slot ``r`` (in
    index order) is refilled from donor ``r mod n_eligible``, at most 4
    slots a donor. A refill samples inside its donor's Gaussian (``p +
    R·(s ⊙ ε)``, ε from :func:`_densify_eps` with ``seed``) and copies the
    donor's other leaves; a donor at or above the ``split_scale_pct``
    quantile of max scale is split: the refill and the donor itself
    shrink by 1/1.6. The Adam moments of refilled rows are zeroed (every
    leaf of ``mu`` and ``nu``; ``count`` is kept). All on the device.

    Returns ``(params, opt_state, DensifyState.zero(N), info)`` with
    ``info`` holding ``recycled``, ``dead`` and ``eligible`` as 0-d
    tensors."""
    n = params.positions.shape[0]
    dev = params.positions.device
    r = torch.arange(n, device=dev)
    opacity = torch.sigmoid(params.raw_opacity)
    dead = opacity < prune_opacity
    scales = torch.exp(params.raw_scales)
    max_scale = torch.amax(scales, dim=1)
    if prune_scale is not None:
        dead = dead | (max_scale > prune_scale)
    score = state.grad_accum / torch.clamp_min(state.denom, 1.0)
    eligible = (~dead) & (score > grad_threshold)

    # Donors by descending score, then the dead slots in index order.
    donor_idx = torch.argsort(torch.where(eligible, -score, float("inf")), stable=True)
    slot_idx = torch.argsort((~dead).to(torch.int8), stable=True)
    n_dead = dead.sum()
    n_eligible = eligible.sum()
    n_recycle = torch.minimum(n_dead, 4 * n_eligible)
    donor_of_slot = donor_idx[r % torch.clamp_min(n_eligible, 1)]
    take = r < n_recycle
    src = torch.where(take, donor_of_slot, slot_idx)
    refill = torch.zeros((n,), dtype=torch.bool, device=dev).index_copy_(0, slot_idx, take)
    source_of = torch.zeros((n,), dtype=torch.int64, device=dev).index_copy_(0, slot_idx, src)
    source_of = torch.where(refill, source_of, r)

    # Split or clone by the donor's extent.
    split_cut = _nanquantile(torch.where(dead, float("nan"), max_scale), split_scale_pct)
    is_split_donor = max_scale >= split_cut

    eps = _densify_eps(seed, n, dev)
    donor_scales = scales[source_of]
    donor_quats = params.quats[source_of]
    qn = donor_quats / torch.clamp_min(
        torch.linalg.norm(donor_quats, dim=1, keepdim=True), 1e-8)
    w, x, y, z = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    sx = donor_scales * eps
    rx = torch.stack([
        (1 - 2 * (y * y + z * z)) * sx[:, 0] + 2 * (x * y - w * z) * sx[:, 1]
        + 2 * (x * z + w * y) * sx[:, 2],
        2 * (x * y + w * z) * sx[:, 0] + (1 - 2 * (x * x + z * z)) * sx[:, 1]
        + 2 * (y * z - w * x) * sx[:, 2],
        2 * (x * z - w * y) * sx[:, 0] + 2 * (y * z + w * x) * sx[:, 1]
        + (1 - 2 * (x * x + y * y)) * sx[:, 2],
    ], dim=1)
    split_shrink = torch.full((), 1.0 / 1.6, device=dev)
    shrink = torch.where(is_split_donor[source_of], split_shrink, 1.0)

    def refilled(leaf, new):
        return torch.where(_rows(refill, leaf), new, leaf)

    new_scales_raw = refilled(params.raw_scales,
                              params.raw_scales[source_of] + torch.log(shrink)[:, None])
    # Split donors shrink too; scatter only the refilled rows' donors (an
    # identity row would write False over a donor's True), the rest into
    # a spare slot n.
    used = torch.zeros((n + 1,), dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(refill, source_of, n), True)
    donor_shrinks = used[:n] & is_split_donor
    new_scales_raw = torch.where(donor_shrinks[:, None],
                                 new_scales_raw + torch.log(split_shrink), new_scales_raw)
    new_params = SceneParams(
        positions=refilled(params.positions, params.positions[source_of] + rx),
        sh=refilled(params.sh, params.sh[source_of]),
        raw_opacity=refilled(params.raw_opacity, params.raw_opacity[source_of]),
        raw_scales=new_scales_raw,
        quats=refilled(params.quats, donor_quats),
        time_params=None if params.time_params is None else refilled(
            params.time_params, params.time_params[source_of]),
    )

    def reset(moments: SceneParams) -> SceneParams:
        return SceneParams(*(
            None if m is None else torch.where(_rows(refill, m), torch.zeros_like(m), m)
            for m in moments
        ))

    new_opt_state = opt_state._replace(mu=reset(opt_state.mu), nu=reset(opt_state.nu))
    info = {"recycled": n_recycle, "dead": n_dead, "eligible": n_eligible}
    return new_params, new_opt_state, DensifyState.zero(n, device=dev), info


# ------------------------------------------------------------------ fitting
def _drain_losses(pending, out) -> None:
    """Move a batch of 0-d device losses to ``out`` as floats in one
    transfer: :func:`fit_scene` keeps each step's loss on the device (a
    ``float()`` per step would make the host wait for every step)."""
    if pending:
        out.extend(torch.stack(pending).tolist())
        pending.clear()


def fit_scene(
    views,
    cfg: RenderConfig,
    params: SceneParams,
    *,
    steps: int = 1000,
    optimizer=None,
    loss_fn=None,
    densify_every: int = 0,
    densify_stop: float = 0.7,
    prune_scale_ratio: float = 0.1,
    opacity_reset_every: int = 0,
    sh_warmup_every: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    log_fn=None,
    log_every: int = 50,
    snapshot_fn=None,
    snapshot_every: int = 0,
    mesh=None,
    strip_bounds=None,
    auto_capacity: bool = True,
    resume_from: Optional[str] = None,
    zero_sh_rest: Optional[bool] = None,
):
    """The 3DGS training loop as one call, on the params' device.

    ``views`` are ``(CameraParams, target)`` pairs or ``(CameraParams,
    target, time)`` triples (all alike), cycled round-robin; a target is
    a planar (3, H, W) float image as :func:`render_for_training` makes.
    Each step is the densifying step (:func:`_make_step_fn`);
    :func:`densify_step` runs every ``densify_every`` steps up to
    ``densify_stop·steps`` (seeded with the step, and with a size prune
    at ``prune_scale_ratio`` × the camera rig's radius), then the
    periodic :func:`reset_opacity`, and checkpoints every
    ``checkpoint_every`` steps (and at the end) under
    ``checkpoint_dir/step_NNNNNN``. The optimizer defaults to
    :func:`make_3dgs_optimizer` with its position schedule over
    ``steps``.

    Losses stay on the device and are drained in one transfer at each
    log (every ``log_every`` steps, ``log_fn(step, loss)``), snapshot
    (``snapshot_fn(step, params, loss)`` every ``snapshot_every`` steps)
    or episode boundary and at the end.

    ``sh_warmup_every`` is upstream's ``oneupSHdegree``: rendering starts
    at SH degree 0 and the degree rises by one before steps
    ``k·sh_warmup_every``; bands above degree 0 are zeroed at the start
    (a warning when they held signal, unless ``zero_sh_rest`` says; False
    keeps them). ``resume_from`` restores a :func:`save_checkpoint`
    directory (``params`` is the template of the same N; a checkpoint
    without densify state restores params and moments) and continues
    every cadence from its step.

    With ``mesh`` (``parallel.make_mesh()``; every rank calls this with
    the same views and the whole ``params``) the loop runs mesh-parallel
    through :func:`make_multichip_train_step`, with optional balanced
    ``strip_bounds``: the params are padded with inert splats
    (:func:`pad_params_for_mesh`) and each rank trains its block of rows;
    targets are padded to the tile grid. Densification, SH warm-up, timed
    views and other losses stay single-device (``ValueError``). Opacity
    resets, callbacks and loss draining run as on one device; the
    snapshot hook gets the whole params. Checkpoints hold the whole
    un-padded state, written by rank 0 (a single-device
    :func:`load_checkpoint` reads them), and a resume restores each
    rank's rows (``load_checkpoint(..., mesh=mesh)``). Every rank returns
    the whole un-padded params.

    ``auto_capacity`` is accepted and not read: the JAX package sizes a
    static instance buffer, and the port's emission has none, so
    ``history["overflow"]`` is always ``[]``.

    Returns ``(params, {"losses", "densify", "overflow"})``: per-step
    losses as floats and per-episode ``{"step", "recycled", "dead",
    "eligible"}`` records."""
    del auto_capacity
    views = list(views)
    if not views:
        raise ValueError("fit_scene needs at least one (cam, target) view")
    arities = {len(v) for v in views}
    if len(arities) != 1 or arities - {2, 3}:
        raise ValueError("views must be all (cam, target) or all "
                         "(cam, target, time)")
    timed = arities == {3}
    optimizer = optimizer or make_3dgs_optimizer(position_lr_max_steps=steps)
    loss_fn = loss_fn or mse_loss
    if mesh is not None:
        # Densify's global sorts would gather the whole scene each episode.
        if timed:
            raise ValueError("timed views are single-chip only (mesh=None)")
        if densify_every:
            raise ValueError("densify_every requires mesh=None")
        if sh_warmup_every:
            raise ValueError("sh_warmup_every requires mesh=None")
        if loss_fn is not mse_loss:
            raise ValueError(
                "mesh mode uses the strip-masked loss built into "
                "make_multichip_train_step; pass loss_fn=None"
            )
        return _fit_scene_mesh(
            views, cfg, params, mesh, strip_bounds=strip_bounds, steps=steps,
            optimizer=optimizer, opacity_reset_every=opacity_reset_every,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            log_fn=log_fn, log_every=log_every, snapshot_fn=snapshot_fn,
            snapshot_every=snapshot_every, resume_from=resume_from)

    n = params.positions.shape[0]
    dev = params.positions.device
    if (sh_warmup_every and not resume_from and params.sh.shape[1] > 3
            and zero_sh_rest is not False):
        if zero_sh_rest is None:
            rest_mag = float(params.sh[:, 3:].abs().max()) if n else 0.0
            if rest_mag > 1e-6:
                warnings.warn(
                    "fit_scene: sh_warmup_every is zeroing non-zero SH "
                    f"bands above degree 0 (max |coeff| {rest_mag:.3g}) — "
                    "a pretrained scene loses its view-dependent color. "
                    "Pass zero_sh_rest=False to keep the bands, or "
                    "zero_sh_rest=True to silence this warning.",
                    RuntimeWarning,
                )
        sh = params.sh.clone()
        sh[:, 3:] = 0.0
        params = params._replace(sh=sh)
    if sh_warmup_every and steps < sh_warmup_every * cfg.sh_degree:
        warnings.warn(
            f"fit_scene: steps={steps} < sh_warmup_every"
            f"*sh_degree={sh_warmup_every * cfg.sh_degree}; SH bands "
            f"above degree {steps // sh_warmup_every} never unlock and "
            "stay zero (view-independent color on those bands)",
            RuntimeWarning,
        )
    opt_state = optimizer.init(params)
    dstate = DensifyState.zero(n, device=dev)
    start_step = 0
    if resume_from:
        try:
            params, opt_state, rd, start_step = load_checkpoint(
                resume_from, params, opt_state, dstate)
            dstate = rd
        except ValueError:
            # A checkpoint without densify accumulators: params + moments.
            params, opt_state, _, start_step = load_checkpoint(
                resume_from, params, opt_state)
    sh_target = cfg.sh_degree
    if sh_warmup_every:
        cfg = dataclasses.replace(
            cfg, sh_degree=min(start_step // sh_warmup_every, sh_target))
    step_fn = _make_step_fn(cfg, optimizer, loss_fn, timed=timed, densify=True)
    # Upstream's size prune is relative to the camera rig's extent (its
    # cameras_extent): the radius of the view-position cloud.
    prune_scale = None
    if prune_scale_ratio:
        cam_pos = np.stack([v[0].position.detach().cpu().numpy() for v in views])
        rig = float(np.linalg.norm(cam_pos - cam_pos.mean(axis=0), axis=1).max())
        prune_scale = prune_scale_ratio * (rig or 1.0)
    losses, pending, episodes = [], [], []
    for s in range(start_step, steps):
        if (sh_warmup_every and cfg.sh_degree < sh_target
                and (s + 1) % sh_warmup_every == 0):
            # Unlock the next band before this step renders (upstream's
            # oneupSHdegree at the top of the iteration).
            cfg = dataclasses.replace(cfg, sh_degree=cfg.sh_degree + 1)
            step_fn = _make_step_fn(cfg, optimizer, loss_fn, timed=timed, densify=True)
        view = views[s % len(views)]
        params, opt_state, dstate, loss, _ = step_fn(
            params, opt_state, dstate, view[0], view[1],
            *((float(view[2]),) if timed else ()))
        pending.append(loss)
        done = s + 1
        episode = (densify_every and done % densify_every == 0
                   and done <= densify_stop * steps)
        boundary = done % max(log_every, 1) == 0 or done == steps or episode
        if episode:
            params, opt_state, dstate, info = densify_step(
                params, opt_state, dstate, seed=done, prune_scale=prune_scale)
            keys = sorted(info)
            counts = torch.stack([info[k] for k in keys]).tolist()
            episodes.append({"step": done, **dict(zip(keys, counts))})
        if opacity_reset_every and done % opacity_reset_every == 0 and done < steps:
            params, opt_state = reset_opacity(params, opt_state)
        if checkpoint_dir and checkpoint_every and (
                done % checkpoint_every == 0 or done == steps):
            save_checkpoint(os.path.join(checkpoint_dir, f"step_{done:06d}"),
                            params, opt_state, dstate, step=done)
        if boundary or (snapshot_fn and snapshot_every and done % snapshot_every == 0):
            _drain_losses(pending, losses)
        if log_fn and done % max(log_every, 1) == 0:
            log_fn(done, losses[-1])
        if snapshot_fn and snapshot_every and done % snapshot_every == 0:
            snapshot_fn(done, params, losses[-1])
    _drain_losses(pending, losses)
    return params, {"losses": losses, "densify": episodes, "overflow": []}


def _fit_scene_mesh(views, cfg, params, mesh, *, strip_bounds, steps, optimizer,
                    opacity_reset_every, checkpoint_dir, checkpoint_every, log_fn, log_every,
                    snapshot_fn, snapshot_every, resume_from):
    """:func:`fit_scene`'s mesh mode (its docstring)."""
    n0 = params.positions.shape[0]
    step_fn, optimizer = make_multichip_train_step(cfg, mesh, optimizer, strip_bounds,
                                                   with_stats=True)
    params = _mesh_shard(pad_params_for_mesh(params, mesh.size), mesh)
    views = [(c, pad_target_for_mesh(t, cfg).to(mesh.device)) for c, t in views]
    opt_state = optimizer.init(params)
    start_step = 0
    if resume_from:
        params, opt_state, _, start_step = load_checkpoint(resume_from, params, opt_state,
                                                           mesh=mesh)
    losses, pending = [], []
    for s in range(start_step, steps):
        cam, target = views[s % len(views)]
        params, opt_state, loss, _ = step_fn(params, opt_state, cam, target)
        pending.append(loss)
        done = s + 1
        boundary = done % max(log_every, 1) == 0 or done == steps
        if opacity_reset_every and done % opacity_reset_every == 0 and done < steps:
            params, opt_state = reset_opacity(params, opt_state)
        if checkpoint_dir and checkpoint_every and (
                done % checkpoint_every == 0 or done == steps):
            _save_mesh_checkpoint(os.path.join(checkpoint_dir, f"step_{done:06d}"),
                                  params, opt_state, mesh, n0, done)
        if boundary or (snapshot_fn and snapshot_every and done % snapshot_every == 0):
            _drain_losses(pending, losses)
        if log_fn and done % max(log_every, 1) == 0:
            log_fn(done, losses[-1])
        if snapshot_fn and snapshot_every and done % snapshot_every == 0:
            snapshot_fn(done, _mesh_gather(params, mesh, n0), losses[-1])
    _drain_losses(pending, losses)
    return _mesh_gather(params, mesh, n0), {"losses": losses, "densify": [], "overflow": []}


def _save_mesh_checkpoint(path, params, opt_state, mesh, n: int, step: int) -> None:
    """The whole un-padded state, gathered from every rank's rows and
    written by rank 0; every rank waits for the write."""
    import torch.distributed as dist

    full = _mesh_gather(params, mesh, n)
    state = AdamState(opt_state.count, _mesh_gather(opt_state.mu, mesh, n),
                      _mesh_gather(opt_state.nu, mesh, n))
    if mesh.rank == 0:
        save_checkpoint(path, full, state, step=step)
    dist.barrier(group=mesh.group)


def evaluate(params: Optional[SceneParams], views, cfg: RenderConfig, render_fn=None,
             per_view_fn=None):
    """Fit quality against views (:func:`fit_scene`'s format): per-view
    and mean PSNR and SSIM of the training render (or of ``render_fn(cam,
    time_value) → (3, H, W)``, where ``params`` may be None).
    ``per_view_fn(i, fb, target, row)`` runs after each view. Returns
    ``{"psnr", "ssim", "per_view"}``."""
    rows = []
    for i, v in enumerate(views):
        cam, target = v[0], v[1]
        tv = float(v[2]) if len(v) == 3 else None
        with torch.no_grad():
            fb = (render_for_training(params, cam, cfg, tv) if render_fn is None
                  else render_fn(cam, tv))
            mse, ss = torch.stack([torch.mean((fb - target) ** 2),
                                   ssim(fb, target)]).tolist()
        row = {"psnr": 10.0 * math.log10(1.0 / max(mse, 1e-12)), "ssim": ss}
        rows.append(row)
        if per_view_fn is not None:
            per_view_fn(i, fb, target, row)
    if not rows:
        raise ValueError("evaluate: no views")
    return {
        "psnr": sum(r["psnr"] for r in rows) / len(rows),
        "ssim": sum(r["ssim"] for r in rows) / len(rows),
        "per_view": rows,
    }


def psnr(a, b, peak: float = 1.0) -> float:
    """PSNR in dB of two arrays (the JAX package's ``oracle.psnr``),
    computed in float64 with NumPy; ``inf`` when they are equal."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * math.log10(peak * peak / mse)


# ----------------------------------------------------------------- datasets
def _has_poses(dataset_dir: str) -> bool:
    return os.path.isfile(os.path.join(dataset_dir, "poses.json"))


def _read_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image

    return np.asarray(Image.open(path))


def dataset_image_shape(dataset_dir: str) -> Tuple[int, int]:
    """(height, width) of a capture dataset's images, read without loading
    the dataset: a COLMAP workspace's calibrated camera, a
    ``transforms*.json`` meta's ``h``/``w`` (or its first frame's image),
    or a ``poses.json`` dataset's first target. Detection order as in
    :func:`load_views`."""
    from gaussianrenderer_tpu_torch.scene import blender, colmap

    if not _has_poses(dataset_dir):
        if colmap.is_colmap_dir(dataset_dir):
            sparse = colmap.find_sparse_dir(dataset_dir)
            cam0 = next(iter(colmap.read_cameras_bin(
                os.path.join(sparse, "cameras.bin")).values()))
            return int(cam0.height), int(cam0.width)
        if blender.is_blender_dir(dataset_dir):
            return blender.blender_image_shape(dataset_dir)
    with open(os.path.join(dataset_dir, "poses.json")) as fh:
        records = json.load(fh)
    if not records:
        raise ValueError(f"{dataset_dir}: poses.json has no views")
    tpath = os.path.join(dataset_dir, records[0]["target"])
    if tpath.endswith(".npy"):
        shape = np.load(tpath, mmap_mode="r").shape
    else:
        shape = _read_image(tpath).shape
    return int(shape[0]), int(shape[1])


def load_views(dataset_dir: str, cfg: RenderConfig, k_sigma: float = 3.0,
               stride: int = 1, split: Optional[str] = None, device="cuda"):
    """A capture dataset directory as :func:`fit_scene` views on ``device``.

    Detection order: ``poses.json``, then a COLMAP workspace
    (:func:`scene.colmap.load_colmap`; pair it with
    :func:`scene.colmap.init_from_points` for the SfM-seeded start), then
    a Blender / NeRF-synthetic / instant-ngp / D-NeRF ``transforms*.json``
    layout (:func:`scene.blender.load_blender`: ``split`` picks
    ``transforms_{split}.json``, default the train split, then a splitless
    ``transforms.json``; RGBA targets composite over ``cfg.background``;
    D-NeRF times make timed triples). ``split`` on any other dataset
    raises ``ValueError``. ``stride`` keeps every Nth view before any
    target is read.

    ``poses.json`` lists records with ``c2w`` (3×4 or 4×4), ``target`` (a
    file name), ``fov_y`` or ``fy``, and optional ``near``, ``far``,
    ``convention`` (default opencv) and ``time`` (making the view a timed
    triple). Its targets are ``.npy`` (H, W, 3+) float or uint8 arrays or
    image files (PIL), each ``cfg.height × cfg.width``; COLMAP and
    Blender images resize same-aspect to that size. Every target becomes
    the planar (3, H, W) float32 bottom-up layout
    :func:`render_for_training` produces."""
    from gaussianrenderer_tpu_torch.scene.camera import Camera

    dev = resolve_device(device)
    if not _has_poses(dataset_dir):
        from gaussianrenderer_tpu_torch.scene import blender, colmap

        if colmap.is_colmap_dir(dataset_dir):
            if split is not None:
                raise ValueError(
                    "split= selects transforms_{split}.json and applies only to "
                    "Blender/NeRF-synthetic datasets; COLMAP workspaces split by "
                    "stride (llffhold)"
                )
            return colmap.load_colmap(dataset_dir, cfg, k_sigma=k_sigma, stride=stride,
                                      device=dev)
        if blender.is_blender_dir(dataset_dir):
            return blender.load_blender(dataset_dir, cfg, k_sigma=k_sigma, stride=stride,
                                        split=split, background=cfg.background, device=dev)
    if split is not None:
        raise ValueError(
            "split= selects transforms_{split}.json and applies only to "
            "Blender/NeRF-synthetic datasets; poses.json datasets split "
            "by stride"
        )
    with open(os.path.join(dataset_dir, "poses.json")) as fh:
        records = json.load(fh)
    views = []
    for rec in records[:: max(stride, 1)]:
        cam = Camera.from_pose(
            np.asarray(rec["c2w"], np.float32), fov_y_deg=rec.get("fov_y"),
            fy=rec.get("fy"), height=cfg.height, aspect=cfg.width / cfg.height,
            near=rec.get("near", 0.1), far=rec.get("far", 100.0),
            convention=rec.get("convention", "opencv"),
        )
        img = _read_image(os.path.join(dataset_dir, rec["target"]))
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if img.ndim != 3 or img.shape[:2] != (cfg.height, cfg.width) or img.shape[2] < 3:
            raise ValueError(
                f"{rec['target']}: expected ({cfg.height}, {cfg.width}, 3), "
                f"got {img.shape}"
            )
        # (H, W, 3) top-down image → planar (3, H, W) bottom-up target.
        target = torch.from_numpy(np.ascontiguousarray(
            img[::-1, :, :3].transpose(2, 0, 1), dtype=np.float32)).to(dev)
        view = (cam.params(k_sigma, device=dev), target)
        views.append(view + (float(rec["time"]),) if "time" in rec else view)
    return views


# ------------------------------------------------------------- checkpoints
_CHECKPOINT_FILE = "state.pt"


def _leaves(tree) -> dict:
    return {k: None if v is None else v.detach().cpu() for k, v in tree._asdict().items()}


def save_checkpoint(path: str, params: SceneParams, opt_state: Optional[AdamState] = None,
                    densify_state: Optional[DensifyState] = None, step: int = 0) -> None:
    """Write the training state (params, Adam moments, densify
    accumulators, step) to the directory ``path`` with ``torch.save``
    (one ``state.pt`` of CPU tensors). The JAX package writes Orbax
    checkpoints: the two formats do not read each other."""
    state = {"params": _leaves(params), "step": int(step)}
    if opt_state is not None:
        state["opt_state"] = {"count": opt_state.count.detach().cpu(),
                              "mu": _leaves(opt_state.mu), "nu": _leaves(opt_state.nu)}
    if densify_state is not None:
        state["densify"] = _leaves(densify_state)
    os.makedirs(path, exist_ok=True)
    torch.save(state, os.path.join(path, _CHECKPOINT_FILE))


def _restore(path: str, saved: dict, template):
    """``template``'s container with the saved tensors on its devices."""
    out = {}
    for name, t in template._asdict().items():
        v = saved.get(name)
        if t is None or v is None:
            if (t is None) != (v is None):
                raise ValueError(f"checkpoint {path}: {name} is "
                                 f"{'absent' if v is None else 'present'} on disk "
                                 "but not in the template")
            out[name] = None
            continue
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {path}: {name} has shape {tuple(v.shape)}, "
                             f"the template {tuple(t.shape)}")
        out[name] = v.to(t.device)
    return type(template)(**out)


def _mesh_rows(saved: dict, mesh, params: bool) -> dict:
    """Saved whole leaves → this rank's rows of their mesh padding:
    :func:`pad_params_for_mesh`'s inert rows for params, zeros for Adam
    moments (the inert rows' gradient is 0, so their moments stay 0)."""
    tree = SceneParams(**saved)
    n = tree.positions.shape[0]
    if params:
        tree = pad_params_for_mesh(tree, mesh.size)
    else:
        pad = -(-n // mesh.size) * mesh.size - n
        tree = SceneParams(*(None if x is None else torch.cat(
            [x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) for x in tree))
    return _mesh_shard(tree, mesh)._asdict()


def load_checkpoint(path: str, params: SceneParams, opt_state: Optional[AdamState] = None,
                    densify_state: Optional[DensifyState] = None, mesh=None):
    """Restore a :func:`save_checkpoint` directory. The passed states are
    templates (the same budget N; a shape that differs raises
    ``ValueError``) and the tensors land on their devices. Returns
    ``(params, opt_state, densify, step)``, None for a template not
    passed: a full checkpoint restores params alone, and a template for a
    part the checkpoint lacks raises ``ValueError``.

    With ``mesh`` the templates are this rank's shards (rows of
    :func:`pad_params_for_mesh`'s output, as ``fit_scene(mesh=...)`` holds
    them): the saved whole state is padded the same way and each rank
    restores its own rows. Densify state is single-device only."""
    path = os.path.abspath(path)
    state = torch.load(os.path.join(path, _CHECKPOINT_FILE), map_location="cpu",
                       weights_only=True)
    wanted = {"params", "step"} | ({"opt_state"} if opt_state is not None else set()) | (
        {"densify"} if densify_state is not None else set())
    missing = wanted - set(state)
    if missing:
        raise ValueError(f"checkpoint {path} has no {sorted(missing)} "
                         f"(on disk: {sorted(state)})")
    if mesh is not None:
        if densify_state is not None:
            raise ValueError("load_checkpoint(mesh=...): densify state is single-device only")
        state["params"] = _mesh_rows(state["params"], mesh, params=True)
        if opt_state is not None:
            for k in ("mu", "nu"):
                state["opt_state"][k] = _mesh_rows(state["opt_state"][k], mesh, params=False)
    params = _restore(path, state["params"], params)
    if opt_state is not None:
        saved = state["opt_state"]
        opt_state = AdamState(saved["count"].to(opt_state.count.device),
                              _restore(path, saved["mu"], opt_state.mu),
                              _restore(path, saved["nu"], opt_state.nu))
    if densify_state is not None:
        densify_state = _restore(path, state["densify"], densify_state)
    return params, opt_state, densify_state, int(state["step"])
