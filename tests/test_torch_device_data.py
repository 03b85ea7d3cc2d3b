"""The device-resident batch feed of the port (``data/device_data.py``),
its fused training windows (``train/graph_step.py``, ``Experiment``) and
the resident encode, on the CPU against the port's host feed and the JAX
reference.

- The cases of ``tests/test_device_data.py`` but the mesh one: step
  purity, epoch partitions, stacked GAN batches, the pair-balanced feed,
  resume, the GAN loop, the resident encode, windows == per-step.
- The device feed takes the host sampler's indices, so its batches equal
  the port's host feed and the reference's host ``BatchIterator`` bit for
  bit, and ``device_data`` training equals host-feed training.
- ``draw_step`` + ``compute_step`` (and the graph's staged buffers) equal
  the step as it drew inline before the split, for SmallCNN, AlexNet with
  dropout and AlexNet at 227 with co-training.
- The logged records of full and ragged windows, at the reference's step
  numbers.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from hashgan_tpu.configs import (
    Config as ConfigJax,
    DataConfig as DataConfigJax,
    EncoderConfig as EncoderConfigJax,
    TrainConfig as TrainConfigJax,
)
from hashgan_tpu.data.pipeline import BatchIterator as BatchIteratorJax
from hashgan_tpu_torch.configs import get_config
from hashgan_tpu_torch.data.device_data import (
    DeviceBatchSource,
    ResidentEncoder,
    make_batch_feed,
)
from hashgan_tpu_torch.data.pipeline import BatchIterator
from hashgan_tpu_torch.data.preprocess import (
    _on,
    alexnet_train_geometry,
    random_crop,
    random_flip,
    step_generator,
    to_encoder_input,
)
from hashgan_tpu_torch.data.synthetic import SyntheticImageDataset, make_synthetic
from hashgan_tpu_torch.losses.pairwise import wml_pairwise_loss
from hashgan_tpu_torch.train.graph_step import GraphedEncoderStep
from hashgan_tpu_torch.train.hash_step import (
    add_fakes,
    encode_dataset,
    make_encoder_train_step,
)
from hashgan_tpu_torch.train.loop import Experiment
from hashgan_tpu_torch.train.state import create_encoder_state, create_gan_state

from torch_threads import one_thread  # noqa: F401


def _indexed_dataset(n, size=8):
    """Labels are the identity matrix, so argmax(labels) recovers the
    gathered row."""
    rng = np.random.default_rng(0)
    return SyntheticImageDataset(
        images=rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8),
        labels=np.eye(n, dtype=np.float32))


def _multilabel_dataset(n, k=7, size=8, p=0.25):
    rng = np.random.default_rng(11)
    return SyntheticImageDataset(
        images=rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8),
        labels=(rng.random((n, k)) < p).astype(np.float32))


def _cfg(workdir, device_data=True, encoder=None, **train):
    """config1 at 16 px, batch 8, float32, in windows of 2 (eval_every 2;
    the tests train without evaluating), logging nothing unless asked."""
    cfg = get_config("config1")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_size=16, n_classes=4,
                                 n_train=64, n_query=12, n_database=40),
        encoder=dataclasses.replace(cfg.encoder, compute_dtype="float32",
                                    **(encoder or {})),
        train=dataclasses.replace(cfg.train, **{
            "batch_size": 8, "log_every": 10**6, "eval_every": 2,
            "checkpoint_every": 10**6, "workdir": str(workdir),
            "device_data": device_data, **train}),
        eval=dataclasses.replace(cfg.eval, R=20))


def _experiment(cfg):
    """An Experiment on the CPU whose log draws no plots (matplotlib takes
    most of a tiny run's time)."""
    exp = Experiment(cfg, device="cpu")
    exp.logger.plot = False
    return exp


def _gan_cfg(workdir, device_data=True, **train):
    """config2 cut to G and D dim 8, z 8, two critic steps, 32 px, batch 4,
    a SmallCNN 16-bit float32 encoder."""
    cfg = get_config("config2")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, n_classes=4, n_train=48,
                                 n_query=8, n_database=24),
        gan=dataclasses.replace(cfg.gan, dim=8, z_dim=8, n_critic=2,
                                compute_dtype="float32"),
        encoder=dataclasses.replace(cfg.encoder, arch="small_cnn", bits=16,
                                    compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, **{
            "batch_size": 4, "log_every": 100, "sample_every": 10**6,
            "eval_every": 10**6, "checkpoint_every": 10**6,
            "workdir": str(workdir), "device_data": device_data, **train}),
        eval=dataclasses.replace(cfg.eval, R=20))


def _encoder_tensors(exp):
    st = exp.encoder_state
    out = dict(st.module.state_dict())
    for i, s in st.optimizer.state_dict()["state"].items():
        out.update({f"{i}.{k}": s[k] for k in ("exp_avg", "exp_avg_sq",
                                                "step")})
    return out, st.step


def _gan_tensors(exp):
    st = exp.gan_state
    out = dict(st.generator.state_dict())
    out.update({f"d.{k}": v for k, v in st.discriminator.state_dict().items()})
    for name, opt in (("g", st.g_opt), ("d", st.d_opt)):
        for i, s in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": s[k]
                        for k in ("exp_avg", "exp_avg_sq", "step")})
    return out, st.step


def _assert_same(a, b):
    (ta, sa), (tb, sb) = a, b
    assert sa == sb
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "hash_loss" in r]


# ---- the source -------------------------------------------------------------


def test_step_purity_and_iter_consistency():
    src = DeviceBatchSource(_indexed_dataset(40), batch_size=8, seed=3)
    a0, l0 = src.batch(5)
    a1, l1 = src.batch(5)
    assert torch.equal(a0, a1) and torch.equal(l0, l1)
    it = src.iter(start_step=7)  # replays batch(7), batch(8), ...
    for step in (7, 8, 9):
        images, labels = next(it)
        want_i, want_l = src.batch(step)
        assert torch.equal(images, want_i) and torch.equal(labels, want_l)


def test_epoch_shuffle_partitions_dataset():
    """Within an epoch the batches are disjoint and cover bpe * B distinct
    rows; the next epoch reshuffles."""
    n, b = 37, 8
    src = DeviceBatchSource(_indexed_dataset(n), batch_size=b, seed=1,
                            epoch_shuffle=True)
    bpe = n // b
    seen = [int(r) for step in range(bpe)
            for r in src.batch(step)[1].argmax(dim=1)]
    assert len(seen) == len(set(seen)) == bpe * b
    assert src.batch(bpe)[1].argmax(dim=1).tolist() != seen[:b]


def test_stacked_gan_batches_shape():
    src = DeviceBatchSource(_indexed_dataset(64, size=4), batch_size=4,
                            n_batches=3)
    images, labels = src.batch(0)
    assert images.shape == (3, 4, 4, 4, 3) and labels.shape == (3, 4, 64)


def test_make_batch_feed_pair_balanced_on_device(tmp_path):
    """The device feed keeps the positive-pair guarantee: each second-half
    partner shares a label with its first-half anchor."""
    ds = _multilabel_dataset(64)
    feed = make_batch_feed(ds, _cfg(tmp_path), start_step=0, seed=0,
                           device=torch.device("cpu"), pair_balanced=True)
    src = DeviceBatchSource(ds, 8, seed=0, pair_balanced=True)
    for step in range(4):
        _, labels = next(feed)
        idx = src.indices(step)
        assert torch.equal(labels, torch.from_numpy(ds.labels[idx]))
        for a, p in zip(idx[:4], idx[4:]):
            if ds.labels[a].sum() > 0:
                assert ds.labels[a] @ ds.labels[p] > 0, (a, p)
            else:
                assert p == a


def test_pair_balanced_step_pure_and_unique_classes_self_partner():
    """Identity labels: every class has one member, so each partner is its
    anchor; batch(step) is pure in step."""
    src = DeviceBatchSource(_indexed_dataset(40), batch_size=8, seed=5,
                            pair_balanced=True)
    i0, l0 = src.batch(3)
    i1, l1 = src.batch(3)
    assert torch.equal(i0, i1) and torch.equal(l0, l1)
    rows = l0.argmax(dim=1)
    assert torch.equal(rows[4:], rows[:4])
    # a row without labels partners itself too
    ds = _indexed_dataset(40)
    ds.labels[:] = 0.0
    idx = DeviceBatchSource(ds, 8, seed=5, pair_balanced=True).indices(3)
    np.testing.assert_array_equal(idx[4:], idx[:4])


def test_pair_balanced_rejects_stacked_batches(tmp_path):
    ds = _multilabel_dataset(32)
    with pytest.raises(ValueError, match="n_batches"):
        DeviceBatchSource(ds, batch_size=4, n_batches=3, pair_balanced=True)
    # the switch takes the host feed for such a stack, as the reference's
    feed = make_batch_feed(ds, _cfg(tmp_path), 0, 0, torch.device("cpu"),
                           n_batches=3, pair_balanced=True)
    want = BatchIterator(ds, 24, pair_balanced=True).batch(0)[0]
    assert torch.equal(next(feed)[0], torch.from_numpy(want).view(
        3, 8, 8, 8, 3))


@pytest.mark.parametrize("mode,n_batches", [
    ("random", 1), ("epoch_shuffle", 1), ("pair_balanced", 1),
    ("random", 3), ("epoch_shuffle", 3)])
def test_device_feed_equals_host_feeds_and_the_reference(tmp_path, mode,
                                                         n_batches):
    """The device feed, the port's host feed and the reference's host
    BatchIterator give the same batches bit for bit, across epochs (50
    rows, 16 a draw) and for the GAN's stacked shape."""
    ds, _ = make_synthetic(50, 5, size=8, multi_label=mode == "pair_balanced",
                           seed=3)
    b = 16 if n_batches == 1 else 4
    kw = dict(epoch_shuffle=mode == "epoch_shuffle",
              pair_balanced=mode == "pair_balanced")
    cpu = torch.device("cpu")
    feeds = []
    for device_data in (True, False):
        cfg = _cfg(tmp_path, device_data=device_data, batch_size=b,
                   epoch_shuffle=kw["epoch_shuffle"])
        feeds.append(make_batch_feed(ds, cfg, start_step=2, seed=7,
                                     device=cpu, n_batches=n_batches,
                                     pair_balanced=kw["pair_balanced"]))
    ref = BatchIteratorJax(ds, b * n_batches, seed=7, start_step=2, **kw)
    for _ in range(8):
        (di, dl), (hi, hl) = (next(f) for f in feeds)
        ri, rl = next(ref)
        assert torch.equal(di, hi) and torch.equal(dl, hl)
        np.testing.assert_array_equal(di.reshape(ri.shape).numpy(), ri)
        np.testing.assert_array_equal(dl.reshape(rl.shape).numpy(), rl)


# ---- the step, split into its draws and its device work ----------------------


def _inline_step(cfg, state, images_u8, labels, sample=None):
    """The stage-II step as it drew inside itself, one draw after another
    from the step's generator: flip, crop, z, geometry, then the forward
    with the generator (AlexNet's dropout seed)."""
    gen = step_generator(cfg.train.seed, state.step)
    x = random_flip(gen, to_encoder_input(images_u8))
    if cfg.train.crop_pad > 0:
        x = random_crop(gen, x, pad=cfg.train.crop_pad)
    weights = None
    if sample is not None:
        n_fake = max(1, int(x.shape[0] * cfg.train.fake_ratio))
        z = torch.randn(n_fake, cfg.gan.z_dim, generator=gen)
        x, labels, weights = add_fakes(x, labels, cfg, sample, _on(z, x.device))
    if cfg.encoder.input_resize > 0:
        x = alexnet_train_geometry(gen, x, cfg.encoder.input_resize,
                                   cfg.encoder.resize_base)
    enc = state.module
    enc.train()
    enc.zero_grad(set_to_none=True)
    codes = enc(x, generator=gen)
    hl = cfg.hash_loss
    loss, _ = wml_pairwise_loss(
        codes, labels, alpha=hl.alpha, similarity=hl.similarity,
        class_balance=hl.class_balance,
        class_balance_cap=hl.class_balance_cap,
        class_balance_mode=hl.class_balance_mode,
        quantization_weight=hl.quantization_weight,
        balance_weight=hl.balance_weight, sample_weight=weights)
    loss.backward()
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.step += 1


@pytest.mark.parametrize("encoder", ["small_cnn", "alexnet", "alexnet_227"])
def test_drawn_step_equals_the_inline_step(encoder):
    """Two steps three ways from one initial state: the step as it drew
    inline, ``make_encoder_train_step`` (``compute_step(draw_step(...))``)
    and the graph path's staged buffers (``GraphedEncoderStep.step``, on
    the CPU without a graph), bit for bit: SmallCNN with crops, AlexNet
    with dropout, and AlexNet on the 256 -> 227 protocol with dropout and
    co-training on generated images (z and the geometry's offsets)."""
    cfg = get_config("config2")
    enc = dict(compute_dtype="float32", bits=16, decay_lr=True, iters=4)
    train = dict(batch_size=4 if encoder != "alexnet_227" else 2, seed=3)
    if encoder == "small_cnn":
        enc["arch"] = "small_cnn"
        train["crop_pad"] = 2
    if encoder == "alexnet_227":
        enc.update(input_resize=227, resize_base=256)
    cfg = dataclasses.replace(
        cfg, use_gan=encoder == "alexnet_227",
        data=dataclasses.replace(cfg.data, n_classes=4),
        gan=dataclasses.replace(cfg.gan, dim=8, z_dim=8,
                                compute_dtype="float32"),
        encoder=dataclasses.replace(cfg.encoder, **enc),
        train=dataclasses.replace(cfg.train, **train))
    ds, _ = make_synthetic(32, 4, size=32, seed=1)
    b = cfg.train.batch_size
    src = DeviceBatchSource(ds, b, seed=9)
    sample = None
    if cfg.use_gan:
        gan = create_gan_state(cfg, "cpu")

        def sample(z, labels):
            with torch.no_grad():
                return gan.generator(z, labels, train=False)

    step = make_encoder_train_step(cfg)
    ends = []
    for route in ("inline", "drawn", "staged"):
        st = create_encoder_state(cfg, "cpu")
        graphed = GraphedEncoderStep(st, src, cfg, sample)
        for s in range(2):
            images, labels = src.batch(s)
            if route == "inline":
                _inline_step(cfg, st, images, labels, sample)
            elif route == "drawn":
                step(st, images, labels, sample=sample)
            else:
                graphed.step()
        ends.append((st.step, st.optimizer.param_groups[0]["lr"],
                     st.module.state_dict()))
        del st, graphed
    (s0, lr0, want), *rest = ends
    for s1, lr1, got in rest:
        assert s1 == s0 == 2 and lr1 == lr0
        for name in want:
            assert torch.equal(got[name], want[name]), name


# ---- Experiment: training, windows, resume, encode ---------------------------


@pytest.mark.parametrize("train", [
    {}, {"crop_pad": 2, "epoch_shuffle": True}, {"pair_sampling": "balanced"},
    {"encoder": {"decay_lr": True, "iters": 8}}])
def test_device_data_training_equals_host_feed_training(tmp_path, train):
    """7 steps (a ragged suffix after windows of 2) with the device feed
    and with the host feed: the same parameters, Adam moments and step
    (and lr, on the linear decay)."""
    runs = []
    for device_data in (True, False):
        wd = tmp_path / str(device_data)
        exp = _experiment(_cfg(wd, device_data, **train))
        exp.train_encoder(7, eval_during=False)
        runs.append(_encoder_tensors(exp))
        lrs = [g["lr"] for g in exp.encoder_state.optimizer.param_groups]
    _assert_same(*runs)
    if "encoder" in train:  # 1e-3 and 1e-2 at 1 - 7/8 of the way
        assert lrs == pytest.approx([1e-3 / 8, 1e-2 / 8])


@pytest.mark.parametrize("train", [{}, {"pair_sampling": "balanced"}])
def test_device_data_training_resume_bit_exact(tmp_path, train):
    """A stop at step 3 of 6 (inside a window of 2), save, restore in a new
    Experiment and 3 more steps: the uninterrupted run's state."""
    cfg = _cfg(tmp_path / "a", **train)
    straight = _experiment(cfg)
    straight.train_encoder(6, eval_during=False)
    cfg_b = _cfg(tmp_path / "b", **train)
    first = _experiment(cfg_b)
    first.train_encoder(3, eval_during=False)
    first.save_checkpoint()
    resumed = _experiment(cfg_b)
    assert resumed.restore_checkpoint() and resumed.encoder_state.step == 3
    resumed.train_encoder(3, eval_during=False)
    _assert_same(_encoder_tensors(straight), _encoder_tensors(resumed))


def test_fused_windows_match_per_step_training(tmp_path):
    """Windows of 3 against windows of 1 (eval_every 3 and 1): the same
    state after 6 steps."""
    runs = []
    for every in (3, 1):
        exp = _experiment(_cfg(tmp_path / str(every), eval_every=every))
        exp.train_encoder(6, eval_during=False)
        runs.append(_encoder_tensors(exp))
    _assert_same(*runs)


def test_window_logs_match_the_reference(tmp_path):
    """Windows of 4 (log every 4): 6 straight steps log the mean of steps
    1-4 at step 4 (the ragged 5-6 log nothing); 3 steps, save, restore and
    7 more log at 4 the last step's metrics of the ragged 3-4, and at 8 the
    mean of 5-8. The values are those of a per-step run, the step numbers
    of the resumed schedule the reference's Experiment's with device_data
    (a ragged window, a full one, a ragged one)."""
    from hashgan_tpu.train.loop import Experiment as ExperimentJax

    def logged(name, every):
        return _experiment(_cfg(tmp_path / name, log_every=every,
                                eval_every=10**6))

    per_step = logged("p", 1)
    per_step.train_encoder(8, eval_during=False)
    each = {r["step"]: r for r in _records(per_step.workdir)}
    keys = [k for k in each[1] if k not in ("step", "time")]

    def mean(lo, hi):
        return {k: np.float32(sum(np.float32(each[s][k])
                                  for s in range(lo, hi + 1)) / (hi - lo + 1))
                for k in keys}

    straight = logged("s", 4)
    straight.train_encoder(6, eval_during=False)
    first = logged("r", 4)
    first.train_encoder(3, eval_during=False)
    first.save_checkpoint()
    resumed = logged("r", 4)
    resumed.restore_checkpoint()
    resumed.train_encoder(7, eval_during=False)
    got_s, got_r = _records(straight.workdir), _records(resumed.workdir)
    assert [r["step"] for r in got_s] == [4]
    assert [r["step"] for r in got_r] == [4, 8]
    for rec, want in ((got_s[0], mean(1, 4)), (got_r[0], each[4]),
                      (got_r[1], mean(5, 8))):
        for k in keys:
            np.testing.assert_allclose(rec[k], want[k], rtol=1e-6, err_msg=k)

    def ref_cfg(wd):
        return ConfigJax(
            data=DataConfigJax(n_train=48, n_query=8, n_database=32,
                               n_classes=4, image_size=8),
            encoder=EncoderConfigJax(arch="small_cnn", bits=16, iters=6,
                                     compute_dtype="float32"),
            train=TrainConfigJax(batch_size=8, log_every=4, eval_every=10**6,
                                 checkpoint_every=10**6, device_data=True,
                                 workdir=wd),
            use_gan=False)

    wd = str(tmp_path / "jr")
    ref_first = ExperimentJax(ref_cfg(wd), use_mesh=False)
    ref_first.train_encoder(iters=3, eval_during=False)
    ref_first.save_checkpoint()
    ref_resumed = ExperimentJax(ref_cfg(wd), use_mesh=False)
    ref_resumed.restore_checkpoint()
    assert int(jax.device_get(ref_resumed.encoder_state.step)) == 3
    ref_resumed.train_encoder(iters=7, eval_during=False)
    assert [r["step"] for r in _records(wd)] == [4, 8]


def test_resident_encoder_matches_host_path(tmp_path):
    """The resident encode equals the per-batch host encode bit for bit
    (same slices, same padded final batch), for the Experiment's splits
    and at a batch that does not divide the split."""
    exp = _experiment(_cfg(tmp_path))
    exp.train_encoder(2, eval_during=False)
    resident = exp.encode_split("database")
    host = Experiment.__new__(Experiment)
    host.__dict__.update(exp.__dict__)
    host.cfg = _cfg(tmp_path, device_data=False)
    assert torch.equal(resident, host.encode_split("database"))
    assert resident.shape == (40, 32)
    split = exp.splits["database"]
    enc = ResidentEncoder(exp._encode, split, batch_size=32)
    assert enc.images.shape[0] == 64
    assert torch.equal(enc(), encode_dataset(exp._encode, split, 32))
    m_resident = exp.evaluate()
    assert m_resident == host.evaluate()


def test_device_data_gan_loop_and_windows(tmp_path):
    """Stage I through the device feed: 4 cycles in windows of 2 (log every
    2) equal 4 cycles of the host feed, one at a time (log every cycle),
    bit for bit; the log at 2 holds the means of cycles 1-2; stage II then
    co-trains on the device feed."""
    runs = []
    for name, device_data, log_every in (("w2", True, 2), ("host", False, 1)):
        cfg = _gan_cfg(tmp_path / name, device_data, log_every=log_every)
        exp = _experiment(cfg)
        exp.train_gan(4)
        runs.append((exp, _gan_tensors(exp)))
    _assert_same(runs[0][1], runs[1][1])
    with open(os.path.join(runs[0][0].workdir, "metrics.jsonl")) as f:
        logs = [r for r in map(json.loads, f) if "grad_penalty" in r]
    with open(os.path.join(runs[1][0].workdir, "metrics.jsonl")) as f:
        each = {r["step"]: r for r in map(json.loads, f) if "grad_penalty" in r}
    assert [r["step"] for r in logs] == [2, 4]
    np.testing.assert_allclose(
        logs[0]["grad_penalty"],
        (np.float32(each[1]["grad_penalty"])
         + np.float32(each[2]["grad_penalty"])) / 2, rtol=1e-6)
    exp = runs[0][0]
    exp.train_encoder(2, eval_during=False)
    assert exp.encoder_state.step == 2
    assert exp._graphed.sample is not None  # co-trained on G's samples
