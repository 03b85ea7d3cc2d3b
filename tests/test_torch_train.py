"""Port of stage-II training (hashgan_tpu_torch/train, data/pipeline.py,
utils/checkpoint.py, cli.py) against the JAX reference, on the CPU.

- One train step at fixed inputs: the same Flax weights (``flax_to_torch``)
  and the same numpy flip mask on both sides, so the step is compared as a
  function: loss, gradients, and parameters after three Adam steps, within
  1e-5 in float32 (the sums of the convolutions run in different orders).
- Batches: ``BatchIterator`` is numpy copied from the reference, so the
  same (seed, step) gives bit-identical batches in all three modes.
- Whole runs are held by outcome, not bit for bit (the flips come from a
  ``torch.Generator``, the reference's from ``jax.random``); resume is
  bit-exact within the port.
"""

import dataclasses
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hashgan_tpu.configs import get_config as get_config_jax
from hashgan_tpu.data.pipeline import BatchIterator as BatchIteratorJax
from hashgan_tpu.data.pipeline import epoch_batches as epoch_batches_jax
from hashgan_tpu.data.preprocess import random_crop as random_crop_jax
from hashgan_tpu.data.preprocess import to_encoder_input as prep_jax
from hashgan_tpu.data.synthetic import make_synthetic as make_synthetic_jax
from hashgan_tpu.losses.pairwise import wml_pairwise_loss as loss_jax
from hashgan_tpu.models.encoders import SmallCNNEncoder as FlaxEncoder
from hashgan_tpu.train.state import make_encoder_tx as make_tx_jax
from hashgan_tpu_torch import cli
from hashgan_tpu_torch.configs import get_config, load_yaml
from hashgan_tpu_torch.data.pipeline import (
    BatchIterator,
    epoch_batches,
    make_batch_feed,
)
from hashgan_tpu_torch.data.preprocess import (
    crop_images,
    flip_images,
    random_crop,
    random_flip,
    step_generator,
    to_encoder_input,
)
from hashgan_tpu_torch.data.synthetic import make_splits, make_synthetic
from hashgan_tpu_torch.eval import oracle
from hashgan_tpu_torch.eval.streaming import (
    distance_histograms_np,
    tie_aware_map_np,
)
from hashgan_tpu_torch.models.convert import flax_to_torch
from hashgan_tpu_torch.models.encoders import SmallCNNEncoder
from hashgan_tpu_torch.ops.hamming import hamming_distance
from hashgan_tpu_torch.ops.pack import pack_codes
from hashgan_tpu_torch.train.hash_step import (
    encoder_loss_and_grad,
    make_encode_fn,
    make_encoder_train_step,
)
from hashgan_tpu_torch.train.loop import Experiment
from hashgan_tpu_torch.train.state import create_encoder_state, make_encoder_tx
from hashgan_tpu_torch.utils.checkpoint import CheckpointManager

TOL = 1e-5


def _batch(seed, b=12, k=4):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
    labels = np.eye(k, dtype=np.float32)[rng.integers(0, k, b)]
    flip = rng.random(b) < 0.5
    return images, labels, flip


def _assert_trees_close(got_sd, want_sd, what):
    for name, want in want_sd.items():
        np.testing.assert_allclose(got_sd[name].numpy(), want.numpy(),
                                   rtol=0, atol=TOL, err_msg=f"{what} {name}")


@pytest.mark.parametrize("mult,decay", [(10.0, False), (1.0, True)])
def test_train_steps_match_jax(mult, decay):
    """Three steps of Adam at the preset's lr, with the 10x hash-layer
    multiplier (applied after Adam in the reference) or with the linear lr
    decay (over 4 iters, so the third step runs at half the lr).

    Adam's first update is lr * g / (|g| + 1e-8): where |g| is near eps,
    the float32 rounding of g (its sums run in another order on each side)
    moves the update by up to lr / 2, and many gradients of a small net at
    init are that small. So each step compares the port's loss and
    gradients with JAX's, then hands JAX's gradients to the port's
    optimiser: the parameters then compare the update rule alone (Adam's
    betas and eps, the multiplier, the schedule), within 1e-5."""
    cfg_j = get_config_jax("config1")
    enc_cfg = dataclasses.replace(cfg_j.encoder, hash_lr_multiplier=mult,
                                  decay_lr=decay, iters=4)
    cfg = get_config("config1")
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, hash_lr_multiplier=mult, decay_lr=decay, iters=4))
    hl = cfg_j.hash_loss

    f_enc = FlaxEncoder(bits=32, dim=16)
    params = jax.device_get(f_enc.init(jax.random.key(2),
                                       jnp.zeros((1, 32, 32, 3)),
                                       train=False)["params"])
    tx = make_tx_jax(enc_cfg)
    opt_state = tx.init(params)
    t_enc = SmallCNNEncoder(bits=32, dim=16)
    t_enc.load_state_dict(flax_to_torch(params))
    opt, sched = make_encoder_tx(t_enc, cfg.encoder)
    assert len(opt.param_groups) == (2 if mult != 1.0 else 1)
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8

    for step in range(3):
        images, labels, flip = _batch(seed=step)
        x = prep_jax(jnp.asarray(images))
        x = jnp.where(jnp.asarray(flip)[:, None, None, None], x[:, :, ::-1, :],
                      x)

        def loss_fn(p):
            codes = f_enc.apply({"params": p}, x, train=True)
            return loss_jax(codes, jnp.asarray(labels), alpha=hl.alpha,
                            similarity=hl.similarity,
                            class_balance=hl.class_balance,
                            class_balance_cap=hl.class_balance_cap,
                            class_balance_mode=hl.class_balance_mode,
                            quantization_weight=hl.quantization_weight,
                            balance_weight=hl.balance_weight)

        (want_loss, want_m), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.device_get(optax.apply_updates(params, updates))

        xt = flip_images(to_encoder_input(torch.from_numpy(images)),
                         torch.from_numpy(flip))
        np.testing.assert_array_equal(xt.numpy(), np.asarray(x))
        loss, metrics = encoder_loss_and_grad(t_enc, xt,
                                              torch.from_numpy(labels), cfg)
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0,
                                   atol=TOL)
        for name in want_m:
            np.testing.assert_allclose(metrics[name].item(),
                                       float(want_m[name]), rtol=0, atol=TOL)
        want_g = flax_to_torch(jax.device_get(grads))
        _assert_trees_close({n: p.grad for n, p in t_enc.named_parameters()},
                            want_g, f"step {step} grad")
        for name, p in t_enc.named_parameters():
            p.grad.copy_(want_g[name])
        opt.step()
        if sched is not None:
            sched.step()
        _assert_trees_close(t_enc.state_dict(), flax_to_torch(params),
                            f"step {step} param")
    if decay:
        assert opt.param_groups[0]["lr"] == pytest.approx(
            float(optax.linear_schedule(1e-3, 0.0, 4)(3)))


@pytest.mark.parametrize("mode", ["random", "epoch_shuffle", "pair_balanced"])
def test_batches_bit_equal_to_reference(mode):
    ds, _ = make_synthetic(50, 5, size=8, multi_label=(mode == "pair_balanced"),
                           seed=3)
    ds_j, _ = make_synthetic_jax(50, 5, size=8,
                                 multi_label=(mode == "pair_balanced"), seed=3)
    np.testing.assert_array_equal(ds.images, ds_j.images)
    np.testing.assert_array_equal(ds.labels, ds_j.labels)
    kw = dict(epoch_shuffle=(mode == "epoch_shuffle"),
              pair_balanced=(mode == "pair_balanced"))
    ours = BatchIterator(ds, 16, seed=7, start_step=2, **kw)
    ref = BatchIteratorJax(ds_j, 16, seed=7, start_step=2, **kw)
    for _ in range(8):  # crosses epochs of 3 batches
        (a, la), (b, lb) = next(ours), next(ref)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_epoch_batches_bit_equal_to_reference():
    ds, _ = make_synthetic(23, 3, size=8, seed=2)
    ours = list(epoch_batches(ds, 8))
    ref = list(epoch_batches_jax(ds, 8))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert ours[-1][2].sum() == 7  # the padded last batch


def test_batch_feed_and_augmentation_are_step_pure():
    ds, _ = make_synthetic(40, 3, size=8, seed=1)
    cfg = get_config("config1")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=8))
    feed = make_batch_feed(ds, cfg, start_step=5, seed=4,
                           device=torch.device("cpu"))
    images, labels = next(feed)
    want, want_l = BatchIterator(ds, 8, seed=4).batch(5)
    assert images.dtype == torch.uint8 and labels.dtype == torch.float32
    np.testing.assert_array_equal(images.numpy(), want)
    np.testing.assert_array_equal(labels.numpy(), want_l)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_batch_feed(ds, dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, device_data=True)), 0, 0, torch.device("cpu"))

    x = to_encoder_input(images)
    a = random_crop(step_generator(0, 9), random_flip(step_generator(0, 9), x))
    b = random_crop(step_generator(0, 9), random_flip(step_generator(0, 9), x))
    assert torch.equal(a, b)
    assert not torch.equal(random_flip(step_generator(0, 10), x),
                           random_flip(step_generator(0, 9), x))


def test_crop_matches_the_reference_edge_padding():
    """The gather-based crop equals the reference's pad(edge) + slice at the
    same offsets (JAX draws its offsets with jax.random; they are read back
    from its output here and fed to the port)."""
    images = np.random.default_rng(2).integers(
        0, 256, (5, 8, 8, 3)).astype(np.float32)
    want = np.asarray(random_crop_jax(jax.random.key(3), jnp.asarray(images),
                                      pad=2))
    padded = np.pad(images, ((0, 0), (2, 2), (2, 2), (0, 0)), mode="edge")
    offsets = [next((y, x) for y in range(5) for x in range(5)
                    if np.array_equal(padded[i, y:y + 8, x:x + 8], want[i]))
               for i in range(5)]
    ry, rx = (torch.tensor(v) for v in zip(*offsets))
    got = crop_images(torch.from_numpy(images), ry, rx, pad=2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_crop_offsets_lie_on_the_diagonal():
    """The reference draws a crop's row and column offsets from one key,
    so they are equal; the port draws one offset an example and uses it for
    both axes. Each crop of distinct pixels equals the window at (r, r) for
    some r, and over 32 examples every r in [0, 2 * pad] occurs."""
    images = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (32, 8, 8, 3)).astype(np.float32))
    r_jax = jax.random.randint(jax.random.key(1), (32,), 0, 5)
    assert jnp.array_equal(r_jax, jax.random.randint(jax.random.key(1),
                                                     (32,), 0, 5))
    got = random_crop(step_generator(0, 3), images, pad=2)
    seen = set()
    for i in range(32):
        hits = [r for r in range(5) if torch.equal(got[i], crop_images(
            images[i:i + 1], torch.tensor([r]), torch.tensor([r]), 2)[0])]
        assert len(hits) == 1, f"example {i}: crop off the diagonal"
        seen.add(hits[0])
    assert seen == set(range(5))


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


GAN_WARNING = "stage-II requested GAN sample augmentation"
RANDOM_INIT_WARNING = "training AlexNet from random init"


def _config2_yaml(tmp_path, encoder=None, **train):
    """config2 (AlexNet 48 bits bf16, use_gan) with its splits cut small and
    its GAN cut to dim 8, z 8, two critic steps a cycle and two cycles."""
    import yaml

    raw = {"preset": "config2",
           "data": {"n_train": 32, "n_query": 8, "n_database": 40},
           "gan": {"dim": 8, "z_dim": 8, "n_critic": 2, "iters": 2},
           "encoder": encoder or {},
           "train": {"batch_size": 8, "log_every": 1, "eval_every": 10**6,
                     "checkpoint_every": 10**6,
                     "workdir": str(tmp_path / "wd"), **train}}
    path = tmp_path / "config2.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _train_recording(exp, steps):
    """Trains ``steps`` steps; returns the messages of every warning."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        exp.train_encoder(steps, eval_during=False)
    return [str(w.message) for w in rec]


def test_stage2_with_use_gan_trains_on_real_images(tmp_path):
    """config2's stage II asks for GAN samples and no generator has been
    trained: the reference's warning, once, and then the very steps of the
    same config with use_gan=False, bit for bit."""
    cfg = load_yaml(_config2_yaml(tmp_path))
    assert cfg.use_gan and cfg.train.use_gan_samples
    assert (cfg.encoder.arch, cfg.encoder.bits) == ("alexnet", 48)
    gan = Experiment(cfg, workdir=str(tmp_path / "gan"), device="cpu")
    assert sum(GAN_WARNING in m for m in _train_recording(gan, 2)) == 1
    plain = Experiment(dataclasses.replace(cfg, use_gan=False),
                       workdir=str(tmp_path / "plain"), device="cpu")
    assert not any(GAN_WARNING in m for m in _train_recording(plain, 2))
    (pa, _, sa), (pb, _, sb) = _state(gan), _state(plain)
    assert sa == sb == 2
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
    # the whole pipeline trains the GAN first, as the reference does, and
    # then the encoder on real and generated images, without the warning
    short = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, iters=1))
    whole = Experiment(short, workdir=str(tmp_path / "run"), device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        m = whole.run()
    assert not any(GAN_WARNING in str(w.message) for w in rec)
    assert whole.gan_state.step == 2 and whole.encoder_state.step == 1
    assert set(m) == {"map_at_5000", "precision_at_h2"}


def test_stage2_without_gan_samples_does_not_warn(tmp_path, monkeypatch):
    """The yaml turns GAN samples off: stage II trains without the warning,
    through the CLI too, and --stage all (stage 1, then stage 2) as well."""
    path = _config2_yaml(tmp_path, use_gan_samples=False)
    cfg = load_yaml(path)
    assert cfg.use_gan and not cfg.train.use_gan_samples
    exp = Experiment(cfg, device="cpu")
    assert not any(GAN_WARNING in m for m in _train_recording(exp, 2))
    assert exp.encoder_state.step == 2
    monkeypatch.setattr(cli, "_device", lambda gpu: torch.device("cpu"))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cli.main(["train", "--config", path, "--stage", "2", "--iters", "1"])
    assert not any(GAN_WARNING in str(w.message) for w in rec)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cli.main(["train", "--config", path, "--iters", "1"])
    assert not any(GAN_WARNING in str(w.message) for w in rec)


def _last_logged_step(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "hash_loss" in r][-1]["step"]


@pytest.mark.parametrize("samples", [True, False])
def test_stage2_restores_the_checkpoint_as_the_reference(tmp_path,
                                                         monkeypatch,
                                                         samples):
    """Stage II of a use_gan config restores the workdir's checkpoint where
    the reference does, on the port and on the reference side by side:

    - Experiment path: 2 steps and a save, then a new Experiment trains 1
      step and then 3 more. With GAN samples asked for and a GAN that never
      stepped, every train_encoder call restores the latest checkpoint (so
      steps held only in memory roll back): steps 3 and 5. Without them,
      nothing restores: 1 and 4;
    - CLI path: ``train --stage 2`` (no --resume) restores on any use_gan
      config: --iters 1 ends at step 3, a second call with --iters 3 at 5."""
    from hashgan_tpu import cli as cli_jax
    from hashgan_tpu.configs import load_yaml as load_yaml_jax
    from hashgan_tpu.train.loop import Experiment as ExperimentJax

    path = _config2_yaml(
        tmp_path, encoder={"arch": "small_cnn", "bits": 32,
                           "compute_dtype": "float32"},
        use_gan_samples=samples)
    monkeypatch.setattr(cli, "_device", lambda gpu: torch.device("cpu"))
    sides = {"port": (load_yaml, Experiment, cli.main, {"device": "cpu"}),
             "reference": (load_yaml_jax, ExperimentJax, cli_jax.main,
                           {"use_mesh": False})}
    ends = {}
    for side, (load, exp_cls, main, kw) in sides.items():
        cfg = load(path)
        got = []
        for route in ("experiment", "cli"):
            wd = str(tmp_path / side / route)
            first = exp_cls(cfg, workdir=wd, **kw)
            first.train_encoder(2, eval_during=False)
            first.save_checkpoint()
            if route == "experiment":
                exp = exp_cls(cfg, workdir=wd, **kw)
                for n in (1, 3):
                    exp.train_encoder(n, eval_during=False)
                    got.append(int(np.asarray(exp.encoder_state.step)))
            else:
                for n in (1, 3):
                    main(["train", "--config", path, "--workdir", wd,
                          "--stage", "2", "--iters", str(n)])
                    got.append(_last_logged_step(wd))
        ends[side] = got
    assert ends["port"] == ends["reference"] == (
        [3, 5, 3, 5] if samples else [1, 4, 3, 5])


def _fake_bvlc_npy(path):
    """A bvlc_alexnet.npy stand-in in the reference's schema ({layer: [W,
    b]}, conv W in HWIO, as tests/test_alexnet_parity.py builds one), the
    convolutions only: the fc layers of the real file are sized for 227x227
    inputs and keep their init at 32x32 anyway."""
    rng = np.random.default_rng(0)
    shapes = {"conv1": (11, 11, 3, 96), "conv2": (5, 5, 48, 256),
              "conv3": (3, 3, 256, 384), "conv4": (3, 3, 192, 384),
              "conv5": (3, 3, 192, 256)}
    blobs = {name: [rng.standard_normal(s).astype(np.float32),
                    rng.standard_normal(s[-1]).astype(np.float32)]
             for name, s in shapes.items()}
    np.save(path, np.asarray(blobs, dtype=object), allow_pickle=True)
    return blobs


def test_pretrained_npy_is_loaded_at_init(tmp_path):
    """encoder.pretrained_npy from a yaml: create_encoder_state loads it
    (conv1 equals the npy's, in OIHW), and the random-init warning stays
    quiet. A non-AlexNet arch keeps its init (no layer matches), as in the
    reference; a missing file raises."""
    npy = str(tmp_path / "bvlc_alexnet.npy")
    blobs = _fake_bvlc_npy(npy)
    cfg = load_yaml(_config2_yaml(tmp_path, encoder={"pretrained_npy": npy}))
    assert cfg.encoder.pretrained_npy == npy
    module = create_encoder_state(cfg, "cpu").module
    np.testing.assert_array_equal(module.conv1.weight.detach().numpy(),
                                  blobs["conv1"][0].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(module.conv1.bias.detach().numpy(),
                                  blobs["conv1"][1])
    exp = Experiment(cfg, device="cpu")
    assert not any(RANDOM_INIT_WARNING in m for m in _train_recording(exp, 1))

    small = _tiny_cfg(tmp_path)
    with_npy = dataclasses.replace(small, encoder=dataclasses.replace(
        small.encoder, pretrained_npy=npy))
    got = create_encoder_state(with_npy, "cpu").module.state_dict()
    want = create_encoder_state(small, "cpu").module.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError):
        create_encoder_state(dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, pretrained_npy=str(tmp_path / "missing.npy"))), "cpu")


@pytest.mark.parametrize("mult,warns", [(10.0, True), (1.0, False)])
def test_random_init_alexnet_warning(tmp_path, mult, warns):
    """AlexNet from random init with the pretrained protocol's 10x hash
    multiplier warns at step 0 (the reference's guard), not at 1.0 and not
    after the first step."""
    cfg = load_yaml(_config2_yaml(
        tmp_path, encoder={"hash_lr_multiplier": mult}, use_gan_samples=False))
    exp = Experiment(cfg, device="cpu")
    first = _train_recording(exp, 1)
    assert sum(RANDOM_INIT_WARNING in m for m in first) == int(warns)
    assert not any(RANDOM_INIT_WARNING in m for m in _train_recording(exp, 1))


def test_saturation_guard_warns_once(tmp_path):
    exp = Experiment(_tiny_cfg(tmp_path), device="cpu")
    with pytest.warns(UserWarning, match="saturated"):
        exp._saturation_guard(5, {"quantization": 0.0, "code_abs_mean": 1.0})
    exp._saturation_guard(6, {"quantization": 0.0, "code_abs_mean": 1.0})
    assert exp._saturation_warned


TINY_YAML = """
preset: config1
data: {{image_size: 16, n_train: 96, n_query: 24, n_database: 160, n_classes: 4}}
encoder: {{bits: 32, iters: 25, compute_dtype: float32}}
train: {{batch_size: 16, log_every: 5, eval_every: 100000, checkpoint_every: 5, workdir: "{wd}"}}
eval: {{R: 50}}
"""


@pytest.fixture
def tiny_yaml(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_device", lambda gpu: torch.device("cpu"))
    p = tmp_path / "tiny.yaml"
    p.write_text(TINY_YAML.format(wd=str(tmp_path / "wd")))
    return str(p)


def test_yaml_config(tiny_yaml):
    cfg = load_yaml(tiny_yaml)
    assert cfg.data.n_train == 96 and cfg.encoder.iters == 25
    assert cfg.use_gan is False and cfg.train.workdir.endswith("wd")
    assert cfg.hash_loss == get_config("config1").hash_loss


def test_cli_train_eval_encode_build_index_query(tiny_yaml, tmp_path,
                                                 capsys):
    cli.main(["train", "--config", tiny_yaml, "--stage", "2", "--iters",
              "10"])
    trained = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(trained) == {"map_at_50", "precision_at_h2"}
    assert 0.0 <= trained["map_at_50"] <= 1.0

    cli.main(["eval", "--config", tiny_yaml])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        trained  # the checkpoint of step 10 restored

    codes_path = str(tmp_path / "codes.npz")
    cli.main(["encode", "--config", tiny_yaml, "--split", "query", "--out",
              codes_path])
    assert json.loads(capsys.readouterr().out.strip())["n"] == 24
    z = np.load(codes_path)
    assert z["codes"].shape == (24, 32) and z["packed"].shape == (24, 1)
    assert z["packed"].dtype == np.uint32 and int(z["bits"]) == 32

    gal_path = str(tmp_path / "gal.npz")
    cli.main(["build-index", "--config", tiny_yaml, "--out", gal_path])
    assert json.loads(capsys.readouterr().out.strip())["items"] == 160
    cli.main(["query", "--gallery", gal_path, "--k", "3", "--n-queries",
              "2"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert len(rec["neighbors"]) == 3

    # resume continues from the saved step
    cli.main(["train", "--config", tiny_yaml, "--stage", "2", "--iters",
              "5", "--resume"])
    capsys.readouterr()
    exp = Experiment(load_yaml(tiny_yaml), device="cpu")
    assert exp.restore_checkpoint() and exp.encoder_state.step == 15
    # stage 1 of a config without a GAN does nothing, as in the reference
    wd = load_yaml(tiny_yaml).train.workdir
    before = _listing(wd)
    cli.main(["train", "--config", tiny_yaml, "--stage", "1"])
    assert _listing(wd) == before
    assert capsys.readouterr().out == ""


def _listing(root):
    """Every file under ``root`` with its size and modification time."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    return out


def test_query_engine_from_artifacts_serves_images(tiny_yaml, tmp_path,
                                                   capsys):
    from hashgan_tpu_torch.index import QueryEngine

    cli.main(["train", "--config", tiny_yaml, "--stage", "2", "--iters", "5"])
    gal_path = str(tmp_path / "gal.npz")
    cli.main(["build-index", "--config", tiny_yaml, "--out", gal_path])
    capsys.readouterr()
    cfg = load_yaml(tiny_yaml)
    engine = QueryEngine.from_artifacts(cfg, cfg.train.workdir, gal_path,
                                        device="cpu")
    splits = make_splits(cfg.data)
    res = engine.query_images(splits["query"].images[:4], k=5)
    exp = Experiment(cfg, device="cpu")
    exp.restore_checkpoint()
    pq = pack_codes(exp.encode_split("query")[:4])
    d = hamming_distance(pq, pack_codes(exp.encode_split("database")))
    order = np.argsort(d.numpy(), axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(res.indices, order)
