"""Port of stage-II training's step and batches (``train/hash_step.py``,
``data/pipeline.py``, ``data/preprocess.py``) against the JAX reference, on
the CPU.

- One train step at fixed inputs: the same Flax weights (``flax_to_torch``)
  and the same numpy flip mask on both sides, so the step is compared as a
  function: loss, gradients, and parameters after three Adam steps, within
  1e-5 in float32 (the sums of the convolutions run in different orders).
- Batches: ``BatchIterator`` is numpy copied from the reference, so the
  same (seed, step) gives bit-identical batches in all three modes; the
  feed and the augmentations are step-pure, and the crops are the
  reference's.
"""

import dataclasses

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
from hashgan_tpu_torch.configs import get_config
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
from hashgan_tpu_torch.data.synthetic import make_synthetic
from hashgan_tpu_torch.models.convert import flax_to_torch
from hashgan_tpu_torch.models.encoders import SmallCNNEncoder
from hashgan_tpu_torch.train.hash_step import encoder_loss
from hashgan_tpu_torch.train.state import make_encoder_tx

from torch_threads import one_thread  # noqa: F401

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
        loss, metrics = encoder_loss(t_enc, xt, torch.from_numpy(labels),
                                     cfg)
        names = [n for n, _ in t_enc.named_parameters()]
        got_g = dict(zip(names, torch.autograd.grad(
            loss, list(t_enc.parameters()))))
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0,
                                   atol=TOL)
        for name in want_m:
            np.testing.assert_allclose(metrics[name].item(),
                                       float(want_m[name]), rtol=0, atol=TOL)
        want_g = flax_to_torch(jax.device_get(grads))
        _assert_trees_close(got_g, want_g, f"step {step} grad")
        for name, p in t_enc.named_parameters():
            p.grad = torch.empty_like(p).copy_(want_g[name])
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
    on_device = make_batch_feed(ds, dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, device_data=True)),
        start_step=5, seed=4, device=torch.device("cpu"))
    images_d, labels_d = next(on_device)  # the device feed: the same batch
    assert torch.equal(images_d, images) and torch.equal(labels_d, labels)

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
