"""The cells' controls on the card, at the cells' own sizes: each has to
come out as not correct, and a sound run as correct. Run on the machine
with the card:

    python -m pytest --noconftest -m cuda hgbench/tests/test_hgbench_card.py
"""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark's controls run at the "
                    "cells' own sizes")
    return "cuda"


def _run(card, name, traffic, seed):
    from hgbench import core
    from hgbench.run import execute

    cell = core.find_cell(core.load_benchmark(ROOT), name,
                          overrides={"traffic": traffic})
    result, _ = execute(cell, seed, 2.0, False, card, time.time())
    return result


CONTROLS = [
    ("config5.codes-q1024", {"mode": "approx"}),
    ("config2.gan-stage1", {"control": "half_batch_reference"}),
    ("config2.stage2-227", {"control": "half_batch_reference"}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,control", CONTROLS,
                         ids=[f"{n}-{'-'.join(map(str, c.values()))}"
                              for n, c in CONTROLS])
def test_the_control_fails_at_the_cells_size(card, name, control):
    for seed in (2**31 + 101, 7, 1234567):
        assert not _run(card, name, control, seed)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted({n for n, _ in CONTROLS}))
def test_a_sound_run_is_correct_at_the_cells_size(card, name):
    assert _run(card, name, {}, 2**31 + 202)["correct"]
