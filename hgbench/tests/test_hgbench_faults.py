"""Each cell's comparison catches what it must, on the CPU at a size a test
run holds: the harness's look for a card is skipped and the rest of a run
is driven with the timed path broken underneath (or the cell's control in
the program's place), and ``correct`` comes out false; the sound run comes
out true."""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hgbench import core  # noqa: E402
from hgbench.run import execute  # noqa: E402

SMALL_GALLERY = {"program": {"data": {"n_database": 16384}}}
# the training cells at float32 on both sides, where the program agrees
# with the reference to round-off, so that a fault shows against the
# cells' own limits
SMALL_TRAINING = {"program": {
    "data": {"n_database": 200, "n_query": 20, "n_train": 256},
    "gan": {"dim": 16, "compute_dtype": "float32"},
    "encoder": {"input_resize": 67, "resize_base": 80,
                "compute_dtype": "float32"},
    "train": {"batch_size": 8}}}
CELLS = {
    "config5.codes-q1024": {
        "config": SMALL_GALLERY,
        "traffic": {"queries_per_call": 64, "pool_calls": 3,
                    "checked_calls": 2}},
    "config2.gan-stage1": {"config": SMALL_TRAINING,
                           "traffic": {"cycles_per_call": 1}},
    "config2.stage2-227": {"config": SMALL_TRAINING,
                           "traffic": {"steps_per_call": 1}},
}


def run(name, traffic=None, seconds=0.6, seed=2**31 + 17):
    over = core.merge(CELLS[name], {"traffic": traffic or {}})
    cell = core.find_cell(core.load_benchmark(ROOT), name, overrides=over)
    result, record = execute(cell, seed, seconds, False, "cpu", time.time())
    return result


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_sound_run_is_correct(name):
    assert run(name)["correct"]


def _alter_codes_answer(monkeypatch, half=False):
    from hashgan_tpu_torch.index import engine

    real = engine.QueryEngine.query_codes

    def broken(self, codes, **kw):
        res = real(self, codes, **kw)
        if half:  # half of the batch left out
            res.distances = res.distances[: len(res.distances) // 2]
            res.indices = res.indices[: len(res.indices) // 2]
        else:  # one answer altered where it is produced
            res.indices = res.indices.copy()
            res.indices[0, 0] = (res.indices[0, 0] + 1) % self.gallery.n
        return res

    monkeypatch.setattr(engine.QueryEngine, "query_codes", broken)


def test_codes_an_altered_answer_is_caught(monkeypatch):
    _alter_codes_answer(monkeypatch)
    assert not run("config5.codes-q1024")["correct"]


def test_codes_half_the_batch_left_out_is_caught(monkeypatch):
    _alter_codes_answer(monkeypatch, half=True)
    assert not run("config5.codes-q1024")["correct"]


def test_codes_control_the_programs_approx_path_fails():
    result = run("config5.codes-q1024", {"mode": "approx"})
    assert not result["correct"]
    assert result["checks"]["rows_wrong"]["value"] > 0


def test_gan_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from hashgan_tpu_torch.train import gan_step

    monkeypatch.setattr(gan_step, "_apply_grads",
                        lambda params, grads, opt, sched: None)
    result = run("config2.gan-stage1")
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_encoder_a_step_that_leaves_the_state_unchanged_is_caught(
        monkeypatch):
    from hashgan_tpu_torch.train import state

    real = state.make_encoder_tx

    def frozen(*args, **kwargs):
        opt, sched = real(*args, **kwargs)
        opt.step = lambda *a, **k: None
        return opt, sched

    monkeypatch.setattr(state, "make_encoder_tx", frozen)
    result = run("config2.stage2-227")
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["config2.gan-stage1", "config2.stage2-227"])
def test_training_half_the_batch_left_out_is_caught(monkeypatch, name):
    from hashgan_tpu_torch.train import loop

    real = loop.make_batch_feed

    def half(dataset, cfg, *args, **kw):
        for images, labels in real(dataset, cfg, *args, **kw):
            if images.dim() == 5:  # the GAN's stack of batches
                b = images.shape[1] // 2
                yield images[:, :b], labels[:, :b]
            else:
                b = images.shape[0] // 2
                yield images[:b], labels[:b]

    monkeypatch.setattr(loop, "make_batch_feed", half)
    assert not run(name)["correct"]


@pytest.mark.parametrize("name", ["config2.gan-stage1", "config2.stage2-227"])
def test_training_control_fp8_reads_above_the_program(name):
    """The fp8 control, the reference in the program's place, reads further
    from the reference than the program on every compared number (on the
    card at the cells' size it reads under 3x the program's largest, so the
    limits stand on the planted faults)."""
    sound, control = run(name), run(name, {"control": "fp8_reference"})
    assert sound["correct"]
    for k, v in sound["checks"].items():
        assert control["checks"][k]["value"] > v["value"], k
