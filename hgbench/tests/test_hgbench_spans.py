"""The ``program_span`` metrics' readers on a fabricated snapshot of the
program's spans, phases and counters, and None where the program has no
snapshot or recorded nothing."""

import os
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from hgbench import core  # noqa: E402

MS = 1_000_000


def _span(count, total_ns, self_ns=None):
    return {"count": count, "total_ns": total_ns,
            "self_ns": total_ns if self_ns is None else self_ns}


QUERY = {
    "spans": {"query": _span(4, 8000 * 1000),
              "query.result": _span(4, 2000 * 1000),
              "scan.select": _span(4, 600 * 1000),
              "scan.merge": _span(4, 200 * 1000),
              "scan.keys": _span(4, 900 * 1000)},
    "counters": {"query.calls": 4},
    "phases": {},
}
TRAIN = {
    "spans": {"gan.cycle": _span(2, 100 * MS, 4 * MS),
              "gan.critic.forward": _span(10, 30 * MS, 20 * MS),
              "gan.penalty.backward": _span(10, 10 * MS),
              "gan.critic.backward": _span(10, 16 * MS),
              "gan.critic.optim": _span(10, 8 * MS),
              "gan.generator.forward": _span(2, 6 * MS),
              "enc.step": _span(1, 40 * MS, 2 * MS),
              "enc.forward": _span(1, 12 * MS, 8 * MS),
              "enc.geometry.forward": _span(1, 4 * MS),
              "train.feed": _span(3, 9 * MS),
              "train.boundary": _span(3, 1 * MS)},
    "counters": {"train.steps": 2},
    "phases": {"setup.splits": {"count": 1, "total_ns": 2_500_000_000}},
}
WANT = {
    "wait_us_per_call.query": (QUERY, 500.0),
    "dispatch_us_per_call.query": (QUERY, 1500.0),
    "select_us_per_call.query": (QUERY, 200.0),
    "feed_ms_per_step.train": (TRAIN, 4.5),
    "forward_ms_per_step.train": (TRAIN, (20 + 6 + 8 + 4) / 2),
    "backward_ms_per_step.train": (TRAIN, (10 + 16) / 2),
    "optim_ms_per_step.train": (TRAIN, 4.0),
    "data_setup_s.train": (TRAIN, 2.5),
}


def _program(monkeypatch, snap):
    """The program's ``utils.profiling`` as one whose snapshot is ``snap``
    (None: a program without one)."""
    fake = types.ModuleType("hashgan_tpu_torch.utils.profiling")
    if snap is not None:
        fake.snapshot = lambda: snap
    monkeypatch.setitem(sys.modules, "hashgan_tpu_torch.utils.profiling",
                        fake)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_fabricated_snapshot(monkeypatch, name):
    snap, want = WANT[name]
    _program(monkeypatch, snap)
    assert core.load_reader(name)(None) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_none_where_nothing_was_recorded(monkeypatch, name):
    _program(monkeypatch, None)      # a program without spans
    assert core.load_reader(name)(None) is None
    _program(monkeypatch, {"spans": {}, "counters": {}, "phases": {}})
    assert core.load_reader(name)(None) is None
    snap, _ = WANT[name]
    _program(monkeypatch, {**snap, "counters": {}})
    if name != "data_setup_s.train":  # a phase is timed without a counter
        assert core.load_reader(name)(None) is None


def test_each_new_metric_is_listed_with_its_cells():
    bench = core.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"] for w in bench["workloads"]}
    for name in WANT:
        m = entries[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert m["workloads"] and set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(core.HERE, "metrics",
                                           name + ".py"))
