"""The cell ``config4.stage2-resnet64`` on the CPU at a size a test run
holds (64 px, batch 8, G and D at dim 16, float32 on both sides, where the
program agrees with the reference to round-off): the sound run is
``correct``, half a batch left out and a step that leaves the state
unchanged are each caught at the cell's limits, and the stored
``reference_flops.encoder_step`` is ``resnet_hash.step_flops`` at the
cell's shapes."""

import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hgbench import core  # noqa: E402
from hgbench.run import execute  # noqa: E402

CELL = "config4.stage2-resnet64"
SMALL = {"config": {"program": {
    "data": {"n_database": 200, "n_query": 20, "n_train": 256},
    "gan": {"dim": 16, "compute_dtype": "float32"},
    "encoder": {"compute_dtype": "float32"},
    "train": {"batch_size": 8}}},
    "traffic": {"steps_per_call": 1}}


def run(seed=2**31 + 17):
    cell = core.find_cell(core.load_benchmark(ROOT), CELL, overrides=SMALL)
    result, _ = execute(cell, seed, 0.6, False, "cpu", time.time())
    return result


def test_a_sound_run_is_correct():
    result = run()
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap",
                                     "grad_gap.median", "change_gap"}


def test_half_the_batch_left_out_is_caught(monkeypatch):
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
    assert not run()["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from hashgan_tpu_torch.train import state

    real = state.make_encoder_tx

    def frozen(*args, **kwargs):
        opt, sched = real(*args, **kwargs)
        opt.step = lambda *a, **k: None
        return opt, sched

    monkeypatch.setattr(state, "make_encoder_tx", frozen)
    result = run()
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_stored_flop_count_is_the_references():
    from hashgan_tpu_torch.models.encoders import build_encoder
    from hashgan_tpu_torch.models.gan import build_gan
    from hgbench.reference import resnet_hash

    config = json.load(open(os.path.join(ROOT, "hgbench", "configs",
                                         "config4.json")))
    cfg = core.program_config(config)
    g, _ = build_gan(cfg)
    enc = build_encoder(cfg.encoder.arch, cfg.encoder.bits)
    b = cfg.train.batch_size
    hp = dict(batch=b, n_fake=int(b * cfg.train.fake_ratio),
              z_dim=cfg.gan.z_dim)
    assert resnet_hash.step_flops(
        dict(enc.named_parameters()), dict(g.named_parameters()), hp,
        cfg.data.n_classes, cfg.data.image_size) == \
        config["reference_flops"]["encoder_step"]


def test_groupnorm_reader_counts_groupnorm_kernels_alone():
    import types

    ns = "void at::native::(anonymous namespace)::"
    kernels = {
        ns + "RowwiseMomentsCUDAKernel<float>(long, float, float const*, "
        "float*, float*)": (17, 0.002),
        ns + "ComputeInternalGradientsCUDAKernel<float>(long, float const*, "
        "float const*, at::AccumulateType<float, true>::type*, "
        "at::AccumulateType<float, true>::type*)": (17, 0.003),
        ns + "GammaBetaBackwardCUDAKernel1<float>(long, long, long, "
        "float const*, float const*)": (17, 0.001),
        # the head's LayerNorm
        ns + "RowwiseMomentsCUDAKernel<float, float>(long, float, "
        "float const*, float*, float*)": (1, 1.0),
        ns + "ComputeInternalGradientsCUDAKernel<float>(long, float const*, "
        "float const*, float const*, at::AccumulateType<float, true>::type*, "
        "at::AccumulateType<float, true>::type*)": (1, 1.0),
        ns + "GammaBetaBackwardSimpleCUDAKernel<float, float>(long, long, "
        "float const*, float const*)": (1, 1.0),
        ns + "GammaBetaBackwardCUDAKernel<float, float>(long, long, "
        "float const*, float const*)": (1, 1.0),
    }
    read = core.load_reader("groupnorm_ms_per_step.train")
    run = types.SimpleNamespace(trace=types.SimpleNamespace(kernels=kernels),
                                counters={"steps": 2})
    assert read(run) == pytest.approx(3.0)
    run.trace.kernels = {k: v for k, v in kernels.items() if v[1] == 1.0}
    assert read(run) is None
