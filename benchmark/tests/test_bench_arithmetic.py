"""The arithmetic of the end-to-end and device metrics on synthetic
timings: rate, the idle share, the union of kernel intervals and the
idle gaps."""

import pytest

from benchmark import core


def rec(**kw):
    return core.Record(**kw)


def read(name, r):
    return core.load_module(core.part_path("metrics", name, ".py")).read(r)


def test_rate_is_all_units_over_the_window():
    assert read("train_steps_per_s", rec(units=10, window_s=4.0)) == pytest.approx(2.5)
    assert read("train_steps_per_s", rec(units=1233, window_s=51.02)) == pytest.approx(
        1233 / 51.02)


def test_setup_and_enqueue():
    r = rec(setup_s=12.5, enqueue_s=[0.002, 0.004])
    assert read("setup_s", r) == 12.5
    assert read("enqueue_ms.train", r) == pytest.approx(3.0)
    assert read("enqueue_ms.train", rec()) is None


def test_idle_share_and_busy_union():
    spans = [(0.0, 1.0), (0.5, 1.5), (3.0, 4.0)]
    assert core.union_length(spans) == pytest.approx(2.5)
    r = rec(trace_window_s=5.0, busy_s=core.union_length(spans))
    assert read("device_idle_pct.train", r) == pytest.approx(50.0)
    assert read("device_idle_pct.train", rec()) is None


def test_idle_gaps_named_by_the_host():
    spans = [(1.0, 2.0), (4.0, 4.5)]
    host = [(0.0, 10.0, "traced_window"), (2.0, 3.9, "aten::nonzero"),
            (3.95, 3.99, "aten::cat")]
    gaps = core.idle_gaps(spans, 0.0, 5.0, host)
    assert gaps[0] == ["aten::nonzero > aten::cat", pytest.approx(2.0)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert sum(g[1] for g in gaps) == pytest.approx(5.0 - 1.5)


def test_kernel_times_per_unit():
    ks = {"tile_kernel(Args)": 0.003, "void fwd_scan_kernel(GrTrainArgs)": 0.002,
          "void bwd_grads_kernel(GrTrainArgs)": 0.004, "elementwise": 1.0}
    assert read("train_compositor_ms.train", rec(kernel_s=ks, trace_units=2)) == pytest.approx(3.0)
    assert read("train_compositor_ms.train", rec(kernel_s={"x": 1.0}, trace_units=3)) is None


def test_layer_spans_and_the_rest_of_the_step():
    spans = {"projection": [2.0, 4.0], "tiling_gather": [1.0, 2.0], "optimizer": [1.5]}
    r = rec(spans_ms=spans, device_ms={"loss_backward_rest": [9.0, 11.0]})
    assert read("projection_ms.train", r) == 3.0
    assert read("tiling_gather_ms.train", r) == 1.5
    assert read("optimizer_ms.train", r) == 1.5
    # The loss and the rest of the backward is read as it was measured,
    # with no other layer's time taken from it.
    assert read("loss_backward_rest_ms.train", r) == pytest.approx(10.0)
    assert read("loss_backward_rest_ms.train", rec(spans_ms=spans)) is None


def test_every_reader_reads_nothing_from_an_empty_run():
    import os

    names = sorted(f[:-3] for f in os.listdir(os.path.join(core.BENCH_DIR, "metrics"))
                   if f.endswith(".py") and not f.startswith("_"))
    assert len(names) >= 10
    for name in names:
        value = read(name, rec())
        assert value is None or (name == "setup_s" and value == 0.0), name
