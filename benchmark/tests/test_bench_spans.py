"""``benchmark/spans.py``: the reduction of a profile with the program's
spans on, on a synthetic event list whose every number is known, and on
a real profile of the tiny cell's step on the CPU."""

import pytest
import torch

import gaussianrenderer_tpu_torch as gt
from benchmark import spans
from benchmark.tests import tiny
from gaussianrenderer_tpu_torch.utils import trace

E = spans.Event
#: Threads: the caller's and autograd's.
T1, T2 = 1, 2


def one_step(at: float, base: int):
    """One step's events, shifted by ``at`` ms; ids from ``base``. Times
    in µs on the profiler's clock, written as ms × 1000."""
    def t(ms):
        return 1e3 * (at + ms)

    def ev(name, kind, thread, a, b, corr=0, link=0):
        return E(name, kind, thread, t(a), t(b), corr and base + corr, link and base + link)

    return [
        ev("gr.step", "host", T1, 0, 100, 1),
        # Projection launches a kernel that runs on after the span closes.
        ev("gr.projection", "host", T1, 5, 20, 2),
        ev("aten::mul", "host", T1, 6, 8, 3),
        ev("cudaLaunchKernel", "runtime", None, 7, 7.5, 501, 3),
        ev("mul_kernel", "device", None, 10, 30, 501, 3),
        # Tiling reads the instance count: a copy, then a wait of 5 ms in
        # which the device runs dry at 33.5 and idles until 45.
        ev("gr.tiling", "host", T1, 20, 40, 4),
        ev("gr.sync.instances", "host", T1, 30, 38, 5),
        ev("aten::_local_scalar_dense", "host", T1, 30.5, 37.5, 10),
        ev("cudaMemcpyAsync", "runtime", None, 31, 32, 502, 10),
        ev("Memcpy DtoH (Device -> Pageable)", "device", None, 33, 33.5, 502, 10),
        ev("cudaStreamSynchronize", "runtime", None, 32, 37, 503, 10),
        # A kernel launched in tiling that starts after tiling has closed.
        ev("cudaLaunchKernel", "runtime", None, 38.5, 39, 504, 4),
        ev("sort_kernel", "device", None, 45, 48, 504, 4),
        # The backward: autograd's thread runs the compositor's backward
        # in its span, and an elementwise backward outside any span.
        ev("gr.backward", "host", T1, 50, 80, 6),
        ev("gr.compositor.bwd", "host", T2, 55, 65, 7),
        ev("cudaLaunchKernel", "runtime", None, 56, 56.5, 505, 7),
        ev("bwd_grads_kernel", "device", None, 57, 60, 505, 7),
        ev("MulBackward0", "host", T2, 66, 70, 8),
        ev("cudaLaunchKernel", "runtime", None, 67, 67.5, 506, 8),
        ev("mul_bwd_kernel", "device", None, 68, 75, 506, 8),
        ev("gr.optimizer", "host", T1, 82, 95, 9),
        ev("cudaLaunchKernel", "runtime", None, 83, 83.2, 507, 9),
        ev("adam_kernel", "device", None, 84, 90, 507, 9),
        # The profiler's copy of a span on the device's timeline.
        ev("gr.step", "device", None, 0, 100),
    ]


@pytest.fixture(scope="module")
def reduced():
    return spans.reduce(one_step(0.0, 0) + one_step(200.0, 1000))


def test_device_time_by_launch_not_by_time(reduced):
    dev = reduced["device_ms"]
    # mul_kernel runs 10-30 ms: past projection's close at 20 ms, still
    # projection's; sort_kernel runs in no span's time, launched in tiling.
    assert dev["gr.projection"] == pytest.approx(20.0)
    assert dev["gr.tiling"] == pytest.approx(3.5)
    assert dev["gr.compositor.bwd"] == pytest.approx(3.0)
    assert dev[spans.BACKWARD] == pytest.approx(7.0)
    assert dev["gr.optimizer"] == pytest.approx(6.0)
    assert set(dev) == {"gr.projection", "gr.tiling", "gr.compositor.bwd", spans.BACKWARD,
                        "gr.optimizer"}
    assert reduced["device_covered"] == pytest.approx(1.0)


def test_device_annotations_dropped(reduced):
    assert reduced["device_events"] == 6
    assert reduced["busy_ms"] == pytest.approx(20 + 0.5 + 3 + 3 + 7 + 6)


def test_self_time_less_children_and_syncs(reduced):
    host = reduced["host_self_ms"]
    assert reduced["steps"] == 2
    assert host["gr.step"] == pytest.approx(100 - 15 - 20 - 30 - 13)
    assert host["gr.projection"] == pytest.approx(15)
    # The sync span is tiling's own; only the 5 ms wait leaves it.
    assert host["gr.tiling"] == pytest.approx(20 - 5)
    assert "gr.sync.instances" not in host
    # autograd's thread: the compositor's backward is gr.backward's child.
    assert host[spans.BACKWARD] == pytest.approx(30 - 10)
    assert host["gr.compositor.bwd"] == pytest.approx(10)
    assert host["gr.optimizer"] == pytest.approx(13)
    assert reduced["host_covered"] == pytest.approx((15 + 15 + 20 + 10 + 13 + 5) / 100)


def test_idle_that_begins_in_a_sync(reduced):
    assert reduced["syncs"] == 1
    assert reduced["sync_wait_ms"] == pytest.approx(5)
    # The gap from 33.5 to 45 begins inside the wait (32-37); the one
    # from 30 to 33 begins before it and is not the sync's.
    assert reduced["sync_idle_ms"] == pytest.approx(45 - 33.5)
    assert reduced["syncs_by_span"] == {"gr.sync.instances": pytest.approx([1, 5])}


def test_idle_named_where_it_begins():
    red = spans.reduce(one_step(0.0, 0))
    assert red["idle_by_span_ms"] == pytest.approx({
        "gr.step": 10 + 9, "gr.tiling": 3, "sync": 45 - 33.5, "gr.compositor.bwd": 8,
        spans.BACKWARD: 9, "gr.optimizer": 10})
    assert red["busy_ms"] + sum(red["idle_by_span_ms"].values()) == pytest.approx(100)


def test_device_alone():
    """The device-only profile: no host operators or spans, no links; the
    synchronize that closes the profile is not the step's."""
    evs = [e._replace(link=0) for e in one_step(0.0, 0) + one_step(200.0, 1000)
           if e.kind != "host" and not e.name.startswith(spans.PREFIX)]
    evs.append(E("cudaDeviceSynchronize", "runtime", None, 285e3, 290e3))
    pace = spans.pace(evs, 2)
    assert pace["syncs"] == 1 and pace["device_events"] == 6
    assert pace["sync_wait_ms"] == pytest.approx(5)
    assert pace["sync_idle_ms"] == pytest.approx(45 - 33.5)
    assert pace["busy_ms"] == pytest.approx(39.5)


def test_metrics_name_each_sum(reduced):
    m = spans.metrics(reduced)
    assert len(m) == 13
    assert m["tiling_gather_device_ms.train"] == pytest.approx(3.5)
    assert m["loss_backward_rest_device_ms.train"] == pytest.approx(7.0)
    assert m["train_compositor_host_ms.train"] == pytest.approx(10)
    assert m["loss_backward_host_ms.train"] == pytest.approx(20)
    assert m["host_syncs.train"] == 1 and m["kernels_per_step.train"] == 6


def test_no_spans_no_numbers():
    evs = [e for e in one_step(0.0, 0) if not e.name.startswith(spans.PREFIX)]
    with pytest.raises(ValueError, match="gr.step"):
        spans.reduce(evs)


def test_same_bits_holds_a_nan_equal_to_itself():
    """The scene files hold a few splats with NaN parameters."""
    x = torch.tensor([[1.0, float("nan"), 3.0]])
    params = gt.SceneParams(x, x, x[:, 0], x, torch.cat([x, x[:, :1]], 1))
    state = gt.make_optimizer().init(params)
    assert spans.same_bits((params, state), (params._replace(sh=x.clone()), state))
    other = params._replace(sh=torch.tensor([[1.0, float("nan"), 3.5]]))
    assert not spans.same_bits((params, state), (other, state))


def test_tiny_cell_on_the_cpu(tiny_scene):
    """The tiny cell's step, spans off and on, from the same start: the
    same bits; then two steps under the CPU profiler, each span once a
    step and the layers covering the step's host time."""
    cell = tiny.cell("trained_500k-sh3", "train-steps", tiny_scene)
    s = spans.setup(cell, 2**31 + 5, "cpu")
    off, state_off = spans.checked(s, 3)
    with trace.enabled():
        on, state_on = spans.checked(s, 3)
    assert on == off and spans.same_bits(state_off, state_on)
    _, _, evs = spans.segment(s["step"], *state_off, s["view"], 3, 2, "cpu")
    red = spans.reduce(evs)
    assert red["steps"] == 2
    assert set(red["host_self_ms"]) == {"gr.step", "gr.projection", "gr.tiling", "gr.gather",
                                        "gr.compositor", "gr.loss", spans.BACKWARD,
                                        "gr.compositor.bwd", "gr.gather.bwd", "gr.optimizer"}
    assert all(v >= 0 for v in red["host_self_ms"].values())
    assert red["host_covered"] > 0.9
    assert red["device_events"] == 0 and red["syncs"] == 0
