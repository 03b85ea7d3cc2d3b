"""Port of stage-II training in ``Experiment`` (``train/loop.py``,
``utils/checkpoint.py``) on the CPU: resume is bit-exact within the port,
checkpoints keep their retention and data provenance, evaluation equals the
numpy oracles, and the step and the Experiment take the AlexNet input
geometry and ``use_gan`` configs. Whole runs are held by outcome, not bit
for bit against the reference (the flips come from a ``torch.Generator``,
the reference's from ``jax.random``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from hashgan_tpu_torch.configs import get_config
from hashgan_tpu_torch.eval import oracle
from hashgan_tpu_torch.eval.streaming import (
    distance_histograms_np,
    tie_aware_map_np,
)
from hashgan_tpu_torch.models.encoders import SmallCNNEncoder
from hashgan_tpu_torch.ops.hamming import hamming_distance
from hashgan_tpu_torch.ops.pack import pack_codes
from hashgan_tpu_torch.train.hash_step import (
    make_encode_fn,
    make_encoder_train_step,
)
from hashgan_tpu_torch.train.loop import Experiment
from hashgan_tpu_torch.utils.checkpoint import CheckpointManager

from torch_threads import one_thread  # noqa: F401


def _tiny_cfg(tmp_path, **train):
    cfg = get_config("config1")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_size=16, n_classes=4,
                                 n_train=64, n_query=12, n_database=40),
        encoder=dataclasses.replace(cfg.encoder, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, **{
            "batch_size": 8, "log_every": 2, "eval_every": 10**6,
            "checkpoint_every": 10**6, "workdir": str(tmp_path), **train}),
        eval=dataclasses.replace(cfg.eval, R=20))


def _state(exp):
    st = exp.encoder_state
    return st.module.state_dict(), st.optimizer.state_dict(), st.step


@pytest.mark.parametrize("train", [{}, {"crop_pad": 2},
                                   {"pair_sampling": "balanced"}])
def test_resume_is_bit_exact(tmp_path, train):
    """2N straight steps against N + save + restore (a new Experiment) + N:
    identical parameters, Adam moments and step."""
    cfg = _tiny_cfg(tmp_path / "a", **train)
    straight = Experiment(cfg, workdir=str(tmp_path / "a"), device="cpu")
    straight.train_encoder(6, eval_during=False)
    first = Experiment(cfg, workdir=str(tmp_path / "b"), device="cpu")
    first.train_encoder(3, eval_during=False)
    first.save_checkpoint()
    resumed = Experiment(cfg, workdir=str(tmp_path / "b"), device="cpu")
    assert resumed.restore_checkpoint()
    assert resumed.encoder_state.step == 3
    resumed.train_encoder(3, eval_during=False)
    (pa, oa, sa), (pb, ob, sb) = _state(straight), _state(resumed)
    assert sa == sb == 6
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
    for i, st in oa["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(st[key], ob["state"][i][key]), (i, key)


def test_checkpoints_retention_and_provenance(tmp_path):
    cfg = _tiny_cfg(tmp_path, checkpoint_every=2)
    exp = Experiment(cfg, device="cpu")
    exp.train_encoder(8, eval_during=False)
    assert exp.ckpt.all_steps() == [4, 6, 8]
    with open(tmp_path / "data_provenance.json") as f:
        assert json.load(f)["provenance"].startswith("synth:v1_16x3_c4_")
    other = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                              noise_scale=20.0))
    with pytest.raises(RuntimeError, match="provenance"):
        Experiment(other, device="cpu").restore_checkpoint()
    fresh = CheckpointManager(str(tmp_path / "empty"))
    assert fresh.restore() is None and fresh.latest_step() is None


def test_experiment_evaluates_as_the_oracle(tmp_path):
    """Exact and streaming evaluation on the experiment's own codes equal
    the numpy oracles; the curves and the metrics log are written."""
    cfg = _tiny_cfg(tmp_path)
    exp = Experiment(cfg, device="cpu")
    exp.train_encoder(4, eval_during=False)
    m = exp.evaluate()
    pq = pack_codes(exp.encode_split("query"))
    pg = pack_codes(exp.encode_split("database"))
    d = hamming_distance(pq, pg).numpy()
    ql, dl = exp.splits["query"].labels, exp.splits["database"].labels
    assert abs(m["map_at_20"] - oracle.mean_average_precision_np(
        d, ql, dl, R=20)) < 1e-6
    assert abs(m["precision_at_h2"] - oracle.precision_at_radius_np(
        d, ql, dl, radius=2)) < 1e-6
    s = exp.evaluate(streaming_threshold=0)
    n_hist, r_hist = distance_histograms_np(d, (ql @ dl.T) > 0, 32)
    assert abs(s["map_at_20_tie_aware"] - tie_aware_map_np(
        n_hist, r_hist, 20)) < 1e-5
    assert s["precision_at_h2"] == pytest.approx(m["precision_at_h2"],
                                                 abs=1e-6)
    for name in ("pr_curve.npz", "precision_at_topn.npz", "metrics.jsonl"):
        assert os.path.exists(tmp_path / name), name
    with open(tmp_path / "metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert rec["step"] == 2 and "time" in rec and "pair_nll" in rec
    assert set(np.load(tmp_path / "pr_curve.npz")) == {"precision", "recall"}


def test_train_step_restores_nothing_it_should_not(tmp_path):
    """The encode function leaves the module's mode as it found it; the
    train step and the Experiment take the AlexNet input geometry (here
    SmallCNN's 16x16 images at 20 -> 18) and ``use_gan`` configs, whose
    stage II trains on real images."""
    enc = SmallCNNEncoder(bits=32, dim=8)
    enc.train()
    make_encode_fn(enc)(np.zeros((2, 16, 16, 3), np.uint8))
    assert enc.training
    enc.eval()
    make_encode_fn(enc)(np.zeros((2, 16, 16, 3), np.uint8))
    assert not enc.training
    cfg = _tiny_cfg(tmp_path)
    resized = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, input_resize=18, resize_base=20))
    make_encoder_train_step(resized)
    exp = Experiment(resized, device="cpu")
    exp.train_encoder(2, eval_during=False)
    assert exp.encoder_state.step == 2
    assert exp.encode_split("query").shape == (cfg.data.n_query, 32)
    make_encoder_train_step(dataclasses.replace(cfg, use_gan=True))


def test_saturation_guard_warns_once(tmp_path):
    exp = Experiment(_tiny_cfg(tmp_path), device="cpu")
    with pytest.warns(UserWarning, match="saturated"):
        exp._saturation_guard(5, {"quantization": 0.0, "code_abs_mean": 1.0})
    exp._saturation_guard(6, {"quantization": 0.0, "code_abs_mean": 1.0})
    assert exp._saturation_warned
