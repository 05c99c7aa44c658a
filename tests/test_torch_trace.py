"""The training step's spans (``gaussianrenderer_tpu_torch/utils/trace.py``)
on the CPU: a small scene through ``make_train_step`` with
``l1_dssim_loss`` and ``make_3dgs_optimizer`` on the training compositor
(16×16 tiles, its plain versions here).

- With spans on, parameters, Adam's state and the loss are the same bits
  as with them off.
- Under ``torch.profiler`` with spans on, each span appears once a step,
  nested as the step nests them.
- With spans off, a profile holds no ``gr.`` event, and ``span`` hands
  out one shared null context.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gaussianrenderer_tpu_torch as gt
from gaussianrenderer_tpu_torch.utils import trace

from test_torch_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_H, _W, _STEPS = 48, 64, 2

#: Each span and the span that holds it (``None``: the step itself).
NESTING = {
    "gr.step": None,
    "gr.projection": "gr.step",
    "gr.tiling": "gr.step",
    "gr.sync.instances": "gr.tiling",
    "gr.gather": "gr.step",
    "gr.compositor": "gr.step",
    "gr.sync.chunk_rows": "gr.compositor",
    "gr.loss": "gr.step",
    "gr.backward": "gr.step",
    "gr.compositor.bwd": "gr.backward",
    "gr.gather.bwd": "gr.backward",
    "gr.optimizer": "gr.step",
}
#: The step's layers in the order they run.
ORDER = ["gr.projection", "gr.tiling", "gr.gather", "gr.compositor", "gr.loss",
         "gr.backward", "gr.optimizer"]


def _setup():
    scene = gt.make_random_scene(300, seed=4, extent=2.0, scale_range=(0.05, 0.25),
                                 device="cpu")
    cfg = gt.RenderConfig(height=_H, width=_W, num_tile_x=_W // 16, num_tile_y=_H // 16,
                          compositor="diff", chunk_size=32)
    cam = gt.Camera()
    cam.set_position([0.3, -0.2, 5.0])
    cam.set_look_at([0.0, 0.0, 0.0])
    cam.set_fov_y(60.0)
    cam.set_aspect_ratio(_W / _H)
    cam.set_clipping_planes(0.2, 100.0)
    cam.update_camera_matrices()
    target = torch.rand((3, _H, _W), generator=torch.Generator().manual_seed(4))
    opt = gt.make_3dgs_optimizer(2.0)
    step, _ = gt.make_train_step(cfg, optimizer=opt, loss_fn=gt.l1_dssim_loss)
    return step, opt, gt.SceneParams.from_scene(scene), cam.params(cfg.k_sigma,
                                                                    device="cpu"), target


def _steps(step, opt, params, cam, target):
    st, losses = opt.init(params), []
    for _ in range(_STEPS):
        params, st, loss = step(params, st, cam, target)
        losses.append(loss)
    return params, st, losses


def _flat(params, st, losses):
    out = [t for t in params if t is not None] + [st.count]
    out += [t for t in st.mu if t is not None] + [t for t in st.nu if t is not None]
    return out + losses


def _gr_events(prof):
    """The profile's ``gr.`` spans: (name, start µs, end µs), by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith(trace.PREFIX)), key=lambda e: e[1])


def test_spans_change_no_bit():
    step, opt, params, cam, target = _setup()
    off = _flat(*_steps(step, opt, params, cam, target))
    with trace.enabled():
        on = _flat(*_steps(step, opt, params, cam, target))
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_each_span_once_a_step_and_nested():
    step, opt, params, cam, target = _setup()
    off = _flat(*_steps(step, opt, params, cam, target))
    with trace.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _flat(*_steps(step, opt, params, cam, target))
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    events = _gr_events(prof)
    steps = [e for e in events if e[0] == "gr.step"]
    assert len(steps) == _STEPS
    for _, a, b in steps:
        inside = [e for e in events if a <= e[1] and e[2] <= b]
        names = [e[0] for e in inside]
        assert sorted(names) == sorted(NESTING), names
        span = {e[0]: e for e in inside}
        for name, parent in NESTING.items():
            if parent is not None:
                p = span[parent]
                assert p[1] <= span[name][1] and span[name][2] <= p[2], (name, parent)
        layers = [span[n] for n in ORDER]
        assert all(x[2] <= y[1] for x, y in zip(layers, layers[1:]))
    assert not [e for e in events if not any(a <= e[1] and e[2] <= b for _, a, b in steps)]


def test_spans_off_leave_no_trace():
    step, opt, params, cam, target = _setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(step, opt, params, cam, target)
    assert not _gr_events(prof)
    assert trace.span("step") is trace.span("optimizer")
    with trace.enabled():
        assert trace.span("step") is not trace.span("step")
    assert trace.span("step") is trace.span("loss")
