"""``replay_share.train``, the share of GAN cycles replayed as one CUDA
graph, on fabricated snapshots of the program's counters, None where the
program has no such counter, and its entry in ``BENCHMARK.json``."""

import os
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from hgbench import core  # noqa: E402

NAME = "replay_share.train"


def _program(monkeypatch, snap):
    """The program's ``utils.profiling`` as one whose snapshot is ``snap``
    (None: a program without one)."""
    fake = types.ModuleType("hashgan_tpu_torch.utils.profiling")
    if snap is not None:
        fake.snapshot = lambda: snap
    monkeypatch.setitem(sys.modules, "hashgan_tpu_torch.utils.profiling",
                        fake)


@pytest.mark.parametrize("counters,want", [
    ({"train.steps": 40, "gan.replays": 40}, 100.0),
    ({"train.steps": 40, "gan.replays": 30}, 75.0),
    ({"train.steps": 40, "gan.replays": 0}, 0.0),
    ({"train.steps": 40}, None),          # the parent: no such counter
    ({"gan.replays": 3}, None),           # no cycle counted
])
def test_replay_share_reads_the_counters(monkeypatch, counters, want):
    _program(monkeypatch, {"spans": {}, "counters": counters, "phases": {}})
    got = core.load_reader(NAME)(None)
    assert got == (None if want is None else pytest.approx(want))


def test_replay_share_without_a_snapshot(monkeypatch):
    _program(monkeypatch, None)
    assert core.load_reader(NAME)(None) is None


def test_replay_share_is_listed_with_its_cell():
    bench = core.load_benchmark()
    m = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert m == {"name": NAME, "unit": "%", "better": "higher",
                 "source": "program_span", "layer": "training step",
                 "moves": "train_images_per_s",
                 "workloads": ["config2.gan-stage1"]}
    assert bench["per_layer"][-1]["name"] == NAME
