"""Restoring a stage-II checkpoint under another ``hash_lr_multiplier``,
and the repository's yaml configs, against the reference, on the CPU.

The reference migrates its optax state between the two layouts of the
encoder's optimiser (one Adam, or Adam and a 10x scale on the hash layer:
``hashgan_tpu/train/loop.py:778-870``); the port's layouts are one or two
parameter groups of ``torch.optim.Adam``. Either way the Adam moments and
step counts carry over bit for bit, and the lr and its schedule follow
the config of the run that restores. The GAN's own migration (an EMA of G
without its statistics) works together with it.

Side by side with the reference: the port's checkpoint holds the
reference's trained weights and Adam moments (``flax_to_torch`` maps
parameters, first and second moments alike), each package restores its
own under the new multiplier, and the two are compared: the step, Adam's
count and the schedule's, the moments bit for bit, each parameter's lr
against the reference's schedule at its count, and the parameters after
one more step on the same batch with the reference's flip and crop draws
fed. In that step the port's gradients agree with the reference's within
1e-5 (the float32 tolerance of tests/test_torch_train.py), and are then
replaced by the reference's, as that file does (Adam's update is
lr * m / (sqrt(v) + 1e-8), so where a gradient is near 1e-8 float32
rounding alone moves it by up to lr / 2); the reference's optimiser
takes the same gradients. The parameters after the step then agree
within 1e-6."""

import dataclasses
import os

import jax
import numpy as np
import optax
import pytest
import torch

from hashgan_tpu.configs import get_config as get_config_jax
from hashgan_tpu.configs import load_yaml as load_yaml_jax
from hashgan_tpu.data import preprocess as pre_jax
from hashgan_tpu.losses.pairwise import wml_pairwise_loss
from hashgan_tpu.train.hash_step import make_encoder_train_step as step_jax
from hashgan_tpu.train.loop import Experiment as ExperimentJax
from hashgan_tpu.train.state import make_encoder_tx as make_tx_jax
from hashgan_tpu_torch.configs import get_config, load_yaml
from hashgan_tpu_torch.models.convert import flax_to_torch
from hashgan_tpu_torch.train.hash_step import make_encoder_train_step
from hashgan_tpu_torch.train.loop import Experiment

from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, ITERS, STEPS = 1e-3, 10, 3


def _cfg(workdir, gan: bool, mult: float, get=get_config, **train):
    """config1 at 16 px, or config2 with a GAN at dim 8 (and an EMA of G),
    each with a float32 SmallCNN and the linear lr decay over ITERS, from
    the port's ``get_config`` or the reference's; ``train`` overrides."""
    cfg = get("config2" if gan else "config1")
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, n_classes=4, n_train=64,
                                 n_query=8, n_database=40,
                                 image_size=32 if gan else 16),
        gan=dataclasses.replace(cfg.gan, dim=8, z_dim=8, n_critic=2,
                                compute_dtype="float32", ema_decay=0.9),
        encoder=dataclasses.replace(cfg.encoder, arch="small_cnn", bits=32,
                                    compute_dtype="float32", lr=LR,
                                    hash_lr_multiplier=mult, decay_lr=True,
                                    iters=ITERS),
        train=dataclasses.replace(cfg.train, batch_size=4 if gan else 8,
                                  log_every=10**6, eval_every=10**6,
                                  checkpoint_every=10**6,
                                  workdir=str(workdir), **train),
        eval=dataclasses.replace(cfg.eval, R=20))


def _moments(exp):
    """{parameter name: (exp_avg, exp_avg_sq, step)} of the encoder."""
    opt = exp.encoder_state.optimizer
    return {name: tuple(opt.state[p][k] for k in ("exp_avg", "exp_avg_sq",
                                                   "step"))
            for name, p in exp.encoder.named_parameters()}


@pytest.mark.parametrize("gan", [False, True])
@pytest.mark.parametrize("saved_mult,mult", [(10.0, 1.0), (1.0, 10.0),
                                             (10.0, 5.0)])
def test_restore_migrates_across_hash_lr_multiplier(tmp_path, gan,
                                                    saved_mult, mult):
    """Save after STEPS steps at ``saved_mult``, restore at ``mult`` (with
    a GAN, from a checkpoint whose EMA statistics were dropped): the
    moments and step counts bit-equal, the step kept, each group's lr the
    current config's at the kept schedule count, and a further step
    taken at it."""
    exp = Experiment(_cfg(tmp_path, gan, saved_mult), device="cpu")
    if gan:
        exp.train_gan(2)
    exp.train_encoder(STEPS, eval_during=False)
    exp.save_checkpoint()
    want = _moments(exp)
    if gan:
        path = os.path.join(exp.ckpt.directory,
                            f"ckpt_{exp.ckpt.latest_step()}.pt")
        saved = torch.load(path, weights_only=True)
        saved["gan"]["g_ema_stats"] = None
        torch.save(saved, path)

    back = Experiment(_cfg(tmp_path, gan, mult), device="cpu")
    assert back.restore_checkpoint()
    st = back.encoder_state
    assert st.step == STEPS
    got = _moments(back)
    assert set(got) == set(want)
    for name, tensors in want.items():
        for key, a, b in zip(("exp_avg", "exp_avg_sq", "step"), tensors,
                             got[name]):
            assert torch.equal(a, b), (name, key)
    bases = [LR] if mult == 1.0 else [LR, LR * mult]
    factor = 1.0 - STEPS / ITERS
    assert st.scheduler.base_lrs == bases
    assert st.scheduler.last_epoch == STEPS
    assert [g["lr"] for g in st.optimizer.param_groups] == [
        b * factor for b in bases]
    assert st.scheduler.get_last_lr() == [b * factor for b in bases]
    if gan:
        gs = back.gan_state
        assert gs.step == 2
        for name, buf in gs.generator.named_buffers():
            assert torch.equal(gs.g_ema_stats[name], buf), name

    head = back.encoder.hash.hash_fc.weight
    before = head.detach().clone()
    back.train_encoder(1, eval_during=False)
    assert st.step == STEPS + 1 and st.scheduler.last_epoch == STEPS + 1
    assert [g["lr"] for g in st.optimizer.param_groups] == [
        b * (1.0 - (STEPS + 1) / ITERS) for b in bases]
    # an Adam update is at most lr (1 - beta1) / sqrt(1 - beta2) ~ 3.16 lr
    moved = (head.detach() - before).abs().max().item()
    assert 0 < moved <= 3.2 * bases[-1] * factor


def _adam_and_schedule(opt_state):
    """(Adam's state, the schedule's count) in an optax state of either
    layout of ``make_encoder_tx``."""
    def leaves(kind):
        return [x for x in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, kind))
            if isinstance(x, kind)]
    (adam,) = leaves(optax.ScaleByAdamState)
    (sched,) = leaves(optax.ScaleByScheduleState)
    return adam, int(sched.count)


@pytest.mark.parametrize("gan", [False, True])
@pytest.mark.parametrize("saved_mult,mult", [(10.0, 1.0), (1.0, 10.0),
                                             (10.0, 5.0)])
def test_restore_migrates_as_the_reference(tmp_path, gan, saved_mult,
                                           mult):
    """The reference trains STEPS steps at ``saved_mult`` and saves (with a
    GAN, without the EMA of G's statistics); the port's checkpoint holds
    the same weights and Adam moments. Each restores its own at ``mult``:
    the step, the counts, the moments, each parameter's lr and the
    parameters after one more step (crop_pad 2, the reference's flip and
    crop draws fed) are the reference's."""
    train = {"crop_pad": 2, "use_gan_samples": False}
    ref = ExperimentJax(_cfg(tmp_path / "ref", gan, saved_mult,
                             get_config_jax, **train), use_mesh=False)
    ref.train_encoder(STEPS, eval_during=False)
    if gan:
        assert ref.gan_state.g_ema_stats is not None
        ref.gan_state = ref.gan_state.replace(g_ema_stats=None)
    ref.save_checkpoint()
    adam, _ = _adam_and_schedule(ref.encoder_state.opt_state)
    mu, nu = flax_to_torch(adam.mu), flax_to_torch(adam.nu)

    exp = Experiment(_cfg(tmp_path / "port", gan, saved_mult, **train),
                     device="cpu")
    exp.train_encoder(STEPS, eval_during=False)
    exp.encoder.load_state_dict(flax_to_torch(ref.encoder_state.params))
    opt = exp.encoder_state.optimizer
    for name, p in exp.encoder.named_parameters():
        assert opt.state[p]["step"].item() == int(adam.count)
        opt.state[p]["exp_avg"].copy_(mu[name])
        opt.state[p]["exp_avg_sq"].copy_(nu[name])
    exp.save_checkpoint()
    if gan:
        path = os.path.join(exp.ckpt.directory,
                            f"ckpt_{exp.ckpt.latest_step()}.pt")
        saved = torch.load(path, weights_only=True)
        saved["gan"]["g_ema_stats"] = None
        torch.save(saved, path)

    cfg_j = _cfg(tmp_path / "ref", gan, mult, get_config_jax, **train)
    ref = ExperimentJax(cfg_j, use_mesh=False)
    assert ref.restore_checkpoint()
    back = Experiment(_cfg(tmp_path / "port", gan, mult, **train),
                      device="cpu")
    assert back.restore_checkpoint()
    st = back.encoder_state
    adam, count = _adam_and_schedule(ref.encoder_state.opt_state)
    assert st.step == int(ref.encoder_state.step) == STEPS
    assert st.scheduler.last_epoch == count == int(adam.count) == STEPS
    mu, nu = flax_to_torch(adam.mu), flax_to_torch(adam.nu)
    lr = optax.linear_schedule(LR, 0.0, ITERS)(count)
    group = {id(p): g["lr"] for g in st.optimizer.param_groups
             for p in g["params"]}
    for name, p in back.encoder.named_parameters():
        state = st.optimizer.state[p]
        assert state["step"].item() == int(adam.count), name
        assert torch.equal(state["exp_avg"], mu[name]), name
        assert torch.equal(state["exp_avg_sq"], nu[name]), name
        head = name.startswith("hash.")
        np.testing.assert_allclose(group[id(p)], lr * (mult if head else 1),
                                   rtol=1e-6, err_msg=name)
    if gan:
        gs = ref.gan_state
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               gs.g_ema_stats, gs.g_stats)
        assert back.gan_state.step == int(gs.step)
        for name, buf in back.gan_state.generator.named_buffers():
            assert torch.equal(back.gan_state.g_ema_stats[name], buf), name

    rng = np.random.default_rng(3)
    n, k, side = 8, cfg_j.data.n_classes, cfg_j.data.image_size
    images = rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)
    labels = np.eye(k, dtype=np.float32)[rng.integers(0, k, n)]
    key = jax.random.key(5)
    flip, crop, metrics, grads = _reference_draws_and_grads(
        ref, cfg_j, images, labels, key)
    enc = ref.encoder_state
    updates, _ = make_tx_jax(cfg_j.encoder).update(grads, enc.opt_state,
                                                   enc.params)
    want_params = flax_to_torch(jax.device_get(
        optax.apply_updates(enc.params, updates)))
    grads = flax_to_torch(jax.device_get(grads))
    want, want_m = step_jax(ref.encoder, cfg_j)(enc, images, labels, key)
    for name, v in want_m.items():  # the rebuilt input is the step's
        np.testing.assert_allclose(float(metrics[name]), float(v), rtol=1e-6,
                                   atol=1e-7, err_msg=name)

    def swap_in_the_reference_grads(opt, args, kwargs):
        for name, p in back.encoder.named_parameters():
            g = grads[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                       atol=1e-5, err_msg=name)
            p.grad.copy_(grads[name])

    st.optimizer.register_step_pre_hook(swap_in_the_reference_grads)
    make_encoder_train_step(back.cfg)(
        st, torch.from_numpy(images), torch.from_numpy(labels),
        flip=torch.from_numpy(flip), crop=torch.from_numpy(crop))
    assert st.step == int(want.step) == STEPS + 1
    for name, p in back.encoder.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want_params[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def _reference_draws_and_grads(ref, cfg_j, images, labels, key):
    """The flip and crop that the reference's step draws from ``key`` at
    its current step (``hashgan_tpu/train/hash_step.py:58-64``), and the
    loss metrics and gradients of its loss on the input they make (the
    step itself returns no gradients)."""
    n, pad = len(images), cfg_j.train.crop_pad
    r_flip, r_crop, r_drop, _ = jax.random.split(
        jax.random.fold_in(key, ref.encoder_state.step), 4)
    flip = np.array(jax.random.bernoulli(r_flip, 0.5, (n, 1, 1, 1))).ravel()
    crop = np.array(jax.random.randint(r_crop, (n,), 0, 2 * pad + 1))
    x = pre_jax.random_crop(r_crop, pre_jax.random_flip(
        r_flip, pre_jax.to_encoder_input(images)), pad=pad)
    hl = cfg_j.hash_loss

    def loss(params):
        codes = ref.encoder.apply({"params": params}, x, train=True,
                                  rngs={"dropout": r_drop})
        return wml_pairwise_loss(
            codes, labels, alpha=hl.alpha, similarity=hl.similarity,
            class_balance=hl.class_balance,
            class_balance_cap=hl.class_balance_cap,
            class_balance_mode=hl.class_balance_mode,
            quantization_weight=hl.quantization_weight,
            balance_weight=hl.balance_weight)

    (_, metrics), grads = jax.value_and_grad(loss, has_aux=True)(
        ref.encoder_state.params)
    return flip, crop, metrics, grads


def test_restore_refuses_an_optimiser_of_another_size(tmp_path):
    """A saved optimiser that holds another number of parameters cannot be
    mapped: the error names both counts."""
    exp = Experiment(_cfg(tmp_path, False, 10.0), device="cpu")
    exp.train_encoder(1, eval_during=False)
    exp.save_checkpoint()
    n = len(list(exp.encoder.parameters()))
    path = os.path.join(exp.ckpt.directory, "ckpt_1.pt")
    saved = torch.load(path, weights_only=True)
    saved["optimizer"]["param_groups"][-1]["params"].pop()
    torch.save(saved, path)
    back = Experiment(_cfg(tmp_path, False, 1.0), device="cpu")
    with pytest.raises(ValueError, match=f"holds {n - 1} parameters.* {n}"):
        back.restore_checkpoint()


YAMLS = ("cifar10_step1.yaml", "cifar10_step2.yaml", "imagenet100.yaml",
         "nuswide_step1.yaml", "nuswide_step2.yaml", "scan_1m.yaml")


@pytest.mark.parametrize("name", YAMLS)
def test_every_yaml_loads_with_the_reference_values(name):
    """Each of the repository's yamls loads through the port's load_yaml
    with the reference's value in every field the port has (the workdir's
    default differs on purpose, so it is compared where the yaml sets
    it)."""
    path = os.path.join(REPO, "configs", name)
    got, want = load_yaml(path), load_yaml_jax(path)
    assert got.name == want.name and got.use_gan == want.use_gan
    with open(path) as f:
        sets_workdir = "workdir" in f.read()
    for section in ("data", "gan", "encoder", "hash_loss", "train", "index",
                    "eval"):
        ours = getattr(got, section)
        for f in dataclasses.fields(ours):
            if (section, f.name) == ("train", "workdir") and not sets_workdir:
                continue
            assert getattr(ours, f.name) == getattr(
                getattr(want, section), f.name), (section, f.name)
    if name.endswith("step2.yaml"):
        assert (got.encoder.input_resize, got.encoder.resize_base) == (227,
                                                                       256)
