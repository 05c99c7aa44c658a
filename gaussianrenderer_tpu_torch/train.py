"""Gaussian-splat optimization on one device (PyTorch port of the
single-device parts of ``train.py``).

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
  time_value]) → (params, opt_state, loss)``.

The optimizer is functional, like optax: ``opt.init(params)`` makes the
state, ``opt.update(grads, state)`` returns the updates and the new state,
and :func:`apply_updates` adds the updates to new parameter tensors.
Densification, ``fit_scene``, evaluation, dataset loading and checkpoints
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Union

import torch

from gaussianrenderer_tpu_torch.config import RenderConfig
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
    card's default for fp32 convolutions) would drown, so it is off here."""
    size = window.shape[0]
    kh = window.reshape(1, 1, size, 1).expand(3, 1, size, 1)
    kw = window.reshape(1, 1, 1, size).expand(3, 1, 1, size)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
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

    def step(params: SceneParams, opt_state: AdamState, cam, target, *time_value):
        if len(time_value) != int(timed):
            raise TypeError(
                "make_train_step: the step takes (params, opt_state, cam, target"
                + (", time_value)" if timed else ")")
            )
        leaves = SceneParams(*(
            None if p is None else p.detach().requires_grad_(True) for p in params
        ))
        loss = loss_fn(leaves, cam, target, cfg, *time_value)
        live = [p for p in leaves if p is not None]
        grads = iter(torch.autograd.grad(loss, live, allow_unused=True))
        grads = SceneParams(*(
            None if p is None else _or_zeros(next(grads), p) for p in leaves
        ))
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = apply_updates(SceneParams(*(
                None if p is None else p.detach() for p in params)), updates)
        return params, opt_state, loss.detach()

    return step, optimizer


def _or_zeros(g, p):
    """A leaf the loss does not reach (``allow_unused``) has gradient 0."""
    return torch.zeros_like(p) if g is None else g
