"""The benchmark's arithmetic on the CPU: the seeded sample, rates,
rooflines and the metric readers."""

import sys
import os

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from hgbench import core, serving  # noqa: E402
from hgbench.record import RunRecord  # noqa: E402
from hgbench.tracing import TraceSummary, summarize, WINDOW  # noqa: E402


def test_reservoir_is_seeded_and_uniform_in_size():
    r1, r2 = serving.Reservoir(8, 11), serving.Reservoir(8, 11)
    for i in range(1000):
        r1.offer(i)
        r2.offer(i)
    assert r1.items == r2.items and len(r1.items) == 8
    assert max(r1.items) > 100  # not just the first calls
    few = serving.Reservoir(8, 11)
    for i in range(3):
        few.offer(i)
    assert few.items == [0, 1, 2]


def _record(**counters):
    cell = core.Cell(name="x", chips=1, config={}, traffic={},
                     end_to_end=[], per_layer=[])
    rec = RunRecord(cell=cell, seed=1, seconds=10.0, device="cuda")
    rec.counters.update(counters)
    return rec


def test_rates_are_over_the_whole_window():
    rec = _record(rows_answered=1024 * 6000, images=96000)
    rec.window_s = 10.5
    assert core.load_reader("queries_per_s")(rec) == pytest.approx(
        1024 * 6000 / 10.5)
    assert core.load_reader("train_images_per_s")(rec) == pytest.approx(
        96000 / 10.5)
    assert core.load_reader("queries_per_s")(_record()) is None


def _trace(window_s, kernels):
    busy = sum(t for _, t in kernels.values())
    return TraceSummary(window_s, [(0.0, busy)], {}, {}, kernels)


def test_k2_roofline_and_mfu_counts():
    rows, n, bits = 1024 * 100, 1_000_000, 128
    rec = _record(rows_answered=rows, n_items=n, bits=bits)
    ops = 2.0 * rows * n * bits
    least = ops / 1979e12
    rec.trace = _trace(0.5, {"void fullkey_scan_s8_kernel<4>(...)":
                             (100, 4 * least)})
    assert core.load_reader("k2_roofline.scan")(rec) == pytest.approx(25.0)
    assert core.load_reader("mfu.scan")(rec) == pytest.approx(
        100 * least / 0.5)
    rec.trace = _trace(0.5, {"other": (3, 0.1)})
    assert core.load_reader("k2_roofline.scan")(rec) is None


def test_idle_share_and_device_ms_per_step():
    rec = _record(steps=200)
    rec.trace = _trace(2.0, {"k": (10, 0.5)})
    for name in ("idle_share.scan", "idle_share.train"):
        assert core.load_reader(name)(rec) == pytest.approx(75.0)
    assert core.load_reader("device_ms_per_step.train")(rec) == \
        pytest.approx(2.5)
    assert core.load_reader("idle_share.train")(_record()) is None


def test_trace_summary_clips_to_the_window_and_names_gaps():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 100.0,
         "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 50.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 300.0, "dur": 200.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 400.0,
         "dur": 250.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 620.0,
         "dur": 400.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 150.0, "dur": 20.0},
    ]
    s = summarize(ev)
    assert s.window_s == pytest.approx(1e-3)
    # k1 clipped to 100-150, k2 and the copy merged to 300-650
    assert s.busy_s == pytest.approx(400e-6)
    assert s.kernels["k1"] == (1, pytest.approx(50e-6))
    assert s.idle_share == pytest.approx(0.6)
    gaps = s.gaps_by_host
    assert gaps["in aten::item"] == pytest.approx(450e-6)
    assert gaps["after cudaMemcpyAsync"] == pytest.approx(150e-6)
    bd = s.breakdown()
    assert bd["device_ops"][0][0] == "copy"
    with pytest.raises(RuntimeError):
        summarize(ev[1:])
