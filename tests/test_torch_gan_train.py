"""Stage I and co-training in the port against the JAX reference, on the CPU
at a tiny size (G and D dim 8, z 8, batch 4, two critic steps a cycle,
32 px, four classes, float32).

- ``make_gan_tx``'s learning rate at several update counts, against optax;
- one cycle against ``make_gan_cycle`` with the reference's own draws fed
  in: the first critic gradient and every metric within rtol 1e-4 / atol
  1e-5; G's running averages within 1e-5; the parameters within 1e-5 on at
  least 99.9% of the entries and every entry within 2 lr + 1e-6 (Adam's
  first step with beta1 0 is about lr * sign(g), so a gradient at noise
  level may flip an entry by 2 lr). G's biases other than ``out_conv``'s
  feed a batch norm, which removes any per-channel constant: their exact
  gradient is 0, so float32 noise picks their first step's sign, and they
  are held to the 2 lr bound alone. The EMA within (1 - decay) times those;
- the stage-II step with generated images against the reference's step
  (its flip mask and z fed in), at fake_pair_weight 1 and 0.5;
- the stacked GAN batch feed, the sample-quality numbers, the template
  classifier, the PNG grid, the stage-1 yamls and the ``_cal`` presets;
- a tiny ``train_gan`` with every boundary, resume 3 + 3 == 6 bit for bit,
  the checkpoint migrations, and the CLI's ``--stage 1|2|all``;
- what the card's CUDA graph of the cycle (``GraphedGanCycle``) stages and
  keeps, on the CPU: ``cycle_lrs`` == the lr each of a cycle's updates
  takes from the schedules, across cycles and a restore; a capturable GAN
  Adam's checkpoint loads into plain Adam and back; ``_gan_cycle`` stays
  the eager cycle on the CPU, at mesh 1 and 2 (the card's tests of the
  graph are in ``test_torch_cuda.py``).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hashgan_tpu.configs import get_config as get_config_jax
from hashgan_tpu.configs import load_yaml as load_yaml_jax
from hashgan_tpu.data.device_data import make_batch_feed as feed_jax
from hashgan_tpu.eval import sample_quality as sq_jax
from hashgan_tpu.losses.wgan_gp import critic_loss_fn as critic_loss_jax
from hashgan_tpu.models.encoders import SmallCNNEncoder as FlaxEncoder
from hashgan_tpu.models.gan import Discriminator as FlaxD
from hashgan_tpu.models.gan import Generator as FlaxG
from hashgan_tpu.train.gan_step import make_gan_cycle as make_gan_cycle_jax
from hashgan_tpu.train.hash_step import (
    make_encoder_train_step as make_step_jax,
)
from hashgan_tpu.train.state import EncoderState as EncoderStateJax
from hashgan_tpu.train.state import GanState as GanStateJax
from hashgan_tpu.train.state import make_encoder_tx as make_enc_tx_jax
from hashgan_tpu.train.state import make_gan_tx as make_gan_tx_jax
from hashgan_tpu.utils.images import save_image_grid as save_grid_jax
from hashgan_tpu_torch import cli
from hashgan_tpu_torch.configs import get_config, load_yaml
from hashgan_tpu_torch.data.pipeline import make_batch_feed
from hashgan_tpu_torch.data.preprocess import from_gan_range, to_gan_range
from hashgan_tpu_torch.data.synthetic import make_synthetic
from hashgan_tpu_torch.eval import sample_quality as sq
from hashgan_tpu_torch.losses.wgan_gp import critic_loss_fn
from hashgan_tpu_torch.models.convert import (
    discriminator_flax_to_torch,
    flax_to_torch,
    generator_flax_to_torch,
)
from hashgan_tpu_torch.models.encoders import SmallCNNEncoder
from hashgan_tpu_torch.parallel import Mesh
from hashgan_tpu_torch.train.gan_step import cycle_lrs, make_gan_cycle
from hashgan_tpu_torch.train.graph_step import WARMUP, GraphedGanCycle
from hashgan_tpu_torch.train.hash_step import make_encoder_train_step
from hashgan_tpu_torch.train.loop import Experiment, _load_optimizer
from hashgan_tpu_torch.train.state import (
    EncoderState,
    create_gan_state,
    make_encoder_tx,
    make_gan_tx,
)
from hashgan_tpu_torch.utils.images import save_image_grid

from torch_threads import one_thread  # noqa: F401

K, B, NC, Z = 4, 4, 2, 8


def _tiny(cfg, **gan):
    """config2 with the GAN at dim 8, z 8, two critic steps, float32, and
    a SmallCNN 32-bit float32 encoder (either package's Config)."""
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, n_classes=K, n_train=64,
                                 n_query=8, n_database=40),
        gan=dataclasses.replace(cfg.gan, dim=8, z_dim=Z, n_critic=NC,
                                compute_dtype="float32", iters=10, **gan),
        encoder=dataclasses.replace(cfg.encoder, arch="small_cnn", bits=32,
                                    compute_dtype="float32", iters=3),
        train=dataclasses.replace(cfg.train, batch_size=B),
        eval=dataclasses.replace(cfg.eval, R=20))


def _fill(shapes, seed):
    """Seeded values for a Flax tree of shapes (Flax's own init compiles
    slowly on the CPU): kernels at 1 / sqrt(fan-in), other leaves small."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return noise / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "var":
            return np.ones(leaf.shape, np.float32)
        if name == "mean":
            return np.zeros(leaf.shape, np.float32)
        return (1.0 if name == "scale" else 0.0) + 0.05 * noise

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _flax_gan(cfg_j):
    g = cfg_j.gan
    fg = FlaxG(image_size=32, n_labels=K, dim=g.dim, dtype=jnp.float32)
    fd = FlaxD(image_size=32, n_labels=K, dim=g.dim, dtype=jnp.float32,
               use_layernorm=g.d_layernorm, projection=g.d_projection)
    g_vars = _fill(jax.eval_shape(lambda: fg.init(
        jax.random.key(0), jnp.zeros((2, Z)), jnp.zeros((2, K)),
        train=True)), 1)
    d_params = _fill(jax.eval_shape(lambda: fd.init(
        jax.random.key(0), jnp.zeros((2, 32, 32, 3)),
        jnp.zeros((2, K))))["params"], 2)
    return fg, fd, g_vars["params"], g_vars["batch_stats"], d_params


def _reference_draws(rng0, step):
    """The draws of the reference's cycle (``gan_step.py:154, 160-163,
    195-196``, ``wgan_gp.py:46``): z and the penalty's weights of each
    critic step, then the generator step's z."""
    rng = jax.random.fold_in(rng0, step)
    z_critic, eps = [], []
    for k in range(NC):
        rz, rgp = jax.random.split(jax.random.fold_in(rng, k))
        z_critic.append(np.array(jax.random.normal(rz, (B, Z))))
        eps.append(np.array(jax.random.uniform(rgp, (B, 1, 1, 1))).reshape(B))
    z_g = np.array(jax.random.normal(jax.random.fold_in(rng, NC), (B, Z)))
    keys = [jax.random.split(jax.random.fold_in(rng, k))[1]
            for k in range(NC)]
    return (torch.from_numpy(np.stack(z_critic)),
            torch.from_numpy(np.stack(eps)), torch.from_numpy(z_g)), keys


def _gan_batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (NC + 1, B, 32, 32, 3), dtype=np.uint8)
    labels = np.eye(K, dtype=np.float32)[rng.integers(0, K, (NC + 1, B))]
    return images, labels


@pytest.mark.parametrize("decay,per_iter", [(True, 1), (True, 5),
                                            (False, 1)])
def test_make_gan_tx_schedule_matches_optax(decay, per_iter):
    """The lr before each of the first updates, and at the end of the
    horizon, equals optax's linear schedule (b1 0, b2 0.9, eps 1e-8)."""
    cfg = dataclasses.replace(get_config("config2").gan, iters=4,
                              decay_lr=decay)
    opt, sched = make_gan_tx(torch.nn.Linear(2, 2), cfg, per_iter)
    assert opt.defaults["betas"] == (0.0, 0.9) and opt.defaults["eps"] == 1e-8
    assert (sched is None) == (not decay)
    want = optax.linear_schedule(cfg.lr, 0.0, cfg.iters * per_iter)
    for count in range(4 * per_iter + 2):
        lr = opt.param_groups[0]["lr"]
        expect = float(want(count)) if decay else cfg.lr
        assert lr == pytest.approx(expect, rel=1e-6, abs=1e-12), count
        opt.step()
        if sched is not None:
            sched.step()
    # the reference's transform takes the same steps on the same gradients
    tx = make_gan_tx_jax(cfg, updates_per_iter=per_iter)
    rng = np.random.default_rng(0)
    w = rng.standard_normal(5).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(w.copy()))
    opt, sched = make_gan_tx(torch.nn.ParameterList([p]), cfg, per_iter)
    w_j, state = jnp.asarray(w), tx.init(jnp.asarray(w))
    for _ in range(6):
        g = rng.standard_normal(5).astype(np.float32)
        update, state = tx.update(jnp.asarray(g), state, w_j)
        w_j = optax.apply_updates(w_j, update)
        p.grad = torch.from_numpy(g)
        opt.step()
        if sched is not None:
            sched.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-6)


def _assert_params_close(got_sd, want_sd, lr, scale=1.0):
    """Within 1e-5 on >= 99.9% of the entries and every entry within
    scale * 2 lr + 1e-6; G's batch-norm-fed biases to the bound alone."""
    bound = scale * 2 * lr + 1e-6
    near = total = 0
    for name, got in got_sd.items():
        d = (got - want_sd[name]).abs()
        assert d.max().item() <= bound, (name, d.max().item())
        noise_level = (name.endswith(".bias") and name.startswith(
            ("blocks.", "input.", "label_embed.")))
        if not noise_level:
            near += int((d <= 1e-5).sum())
            total += d.numel()
    assert near >= 0.999 * total, (near, total)


@pytest.mark.parametrize("gan", [
    {"ema_decay": 0.9},
    {"ema_decay": 0.0, "d_projection": True, "d_layernorm": True,
     "acgan_fake_scale": 0.5}])
def test_one_cycle_matches_the_reference(gan):
    cfg_j = _tiny(get_config_jax("config2"), **gan)
    cfg = _tiny(get_config("config2"), **gan)
    fg, fd, g_params, g_stats, d_params = _flax_gan(cfg_j)
    g_tx = make_gan_tx_jax(cfg_j.gan)
    d_tx = make_gan_tx_jax(cfg_j.gan, updates_per_iter=NC)
    ema = cfg_j.gan.ema_decay > 0
    state_j = GanStateJax(
        g_params=g_params, g_stats=g_stats, g_opt=g_tx.init(g_params),
        d_params=d_params, d_opt=d_tx.init(d_params),
        step=jnp.zeros((), jnp.int32),
        g_ema=jax.tree_util.tree_map(jnp.copy, g_params) if ema else None,
        g_ema_stats=jax.tree_util.tree_map(jnp.copy, g_stats) if ema else None)
    images, labels = _gan_batch()
    rng0 = jax.random.key(11)
    draws, gp_keys = _reference_draws(rng0, 0)

    st = create_gan_state(cfg, "cpu")
    st.generator.load_state_dict(generator_flax_to_torch(g_params, g_stats))
    st.discriminator.load_state_dict(discriminator_flax_to_torch(d_params))
    if ema:
        st.g_ema = {k: p.detach().clone()
                    for k, p in st.generator.named_parameters()}
        st.g_ema_stats = {k: b.clone() for k, b in st.generator.named_buffers()}

    # the first critic step's gradient
    fake_j, _ = fg.apply({"params": g_params, "batch_stats": g_stats},
                         draws[0][0].numpy(), labels[0], train=True,
                         mutable=["batch_stats"])
    real = images[0].astype(np.float32) / 127.5 - 1.0
    kw = dict(gp_lambda=10.0, acgan_scale=1.0,
              acgan_fake_scale=cfg.gan.acgan_fake_scale, multi_label=False)
    want_g = jax.jit(jax.grad(lambda p: critic_loss_jax(
        lambda x: fd.apply({"params": p}, x, labels[0]), gp_keys[0], real,
        fake_j, labels[0], **kw)[0]))(d_params)
    with torch.no_grad():
        fake = st.generator(draws[0][0], torch.from_numpy(labels[0]),
                            train=True, update=False)
    loss, _ = critic_loss_fn(st.discriminator, torch.from_numpy(real), fake,
                             torch.from_numpy(labels[0]), draws[1][0], **kw)
    got_g = torch.autograd.grad(loss, list(st.discriminator.parameters()))
    want_g = discriminator_flax_to_torch(jax.device_get(want_g))
    for (name, _), g in zip(st.discriminator.named_parameters(), got_g):
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)

    new_j, want_m = make_gan_cycle_jax(fg, fd, cfg_j)(
        state_j, jnp.asarray(images), jnp.asarray(labels), rng0)
    new_j = jax.device_get(new_j)
    got_m = make_gan_cycle(cfg)(st, torch.from_numpy(images),
                                torch.from_numpy(labels), draws)
    assert set(got_m) == set(want_m)
    assert ("wasserstein_noproj" in got_m) == cfg.gan.d_projection
    for k, v in want_m.items():
        np.testing.assert_allclose(got_m[k].item(), float(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert st.step == 1
    want_g_sd = generator_flax_to_torch(new_j.g_params, new_j.g_stats)
    got_g_sd = st.generator.state_dict()
    for name, buf in st.generator.named_buffers():  # G's running averages
        np.testing.assert_allclose(buf.numpy(), want_g_sd[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    lr = cfg.gan.lr
    _assert_params_close(got_g_sd, want_g_sd, lr)
    _assert_params_close(st.discriminator.state_dict(),
                         discriminator_flax_to_torch(new_j.d_params), lr)
    if ema:
        want_ema = generator_flax_to_torch(new_j.g_ema, new_j.g_ema_stats)
        _assert_params_close(st.g_ema, want_ema, lr,
                             scale=1 - cfg.gan.ema_decay)
        for name, buf in st.g_ema_stats.items():
            np.testing.assert_allclose(buf.numpy(), want_ema[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("weight", [1.0, 0.5])
def test_stage2_fake_step_matches_the_reference(weight):
    """One encoder step on 8 real images and 4 generated ones (the real
    batch's first labels), the reference's flip mask and z fed in: the
    metrics within rtol 1e-4 / atol 1e-5, the parameters as Adam's first
    step allows (lr 1e-3, 10x on the hash layer)."""
    cfg_j = get_config_jax("config2")
    cfg_j = _tiny(dataclasses.replace(cfg_j, train=dataclasses.replace(
        cfg_j.train, fake_pair_weight=weight)))
    cfg = get_config("config2")
    cfg = _tiny(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, fake_pair_weight=weight)))
    fg, _, g_params, g_stats, _ = _flax_gan(cfg_j)
    g_stats = jax.tree_util.tree_map(lambda a: a + 0.2, g_stats)
    f_enc = FlaxEncoder(bits=32, dim=16)
    params = jax.device_get(jax.jit(lambda: f_enc.init(
        jax.random.key(2), jnp.zeros((1, 32, 32, 3)), train=False))()["params"])
    state_j = EncoderStateJax(params=params,
                              opt_state=make_enc_tx_jax(cfg_j.encoder).init(params),
                              step=jnp.zeros((), jnp.int32))
    rng = np.random.default_rng(7)
    n = 8
    images = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    labels = np.eye(K, dtype=np.float32)[rng.integers(0, K, n)]
    rng0 = jax.random.key(5)
    new_j, want_m = make_step_jax(f_enc, cfg_j, generator=fg)(
        state_j, jnp.asarray(images), jnp.asarray(labels), rng0, g_params,
        g_stats)
    r_flip, _, _, r_z = jax.random.split(jax.random.fold_in(rng0, 0), 4)
    flip = np.array(jax.random.bernoulli(r_flip, 0.5, (n, 1, 1, 1))).reshape(n)
    z = np.array(jax.random.normal(r_z, (n // 2, Z)))

    enc = SmallCNNEncoder(bits=32, dim=16)
    enc.load_state_dict(flax_to_torch(params))
    opt, sched = make_encoder_tx(enc, cfg.encoder)
    state = EncoderState(enc, opt, sched)
    g = create_gan_state(cfg, "cpu").generator
    g.load_state_dict(generator_flax_to_torch(g_params, g_stats))

    def sample(zz, ll):
        with torch.no_grad():
            return g(zz, ll, train=False)

    got_m = make_encoder_train_step(cfg)(
        state, torch.from_numpy(images), torch.from_numpy(labels),
        sample=sample, flip=torch.from_numpy(flip), z=torch.from_numpy(z))
    for k, v in want_m.items():
        np.testing.assert_allclose(got_m[k].item(), float(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    want_sd = flax_to_torch(jax.device_get(new_j.params))
    bound = 2 * 1e-3 * cfg.encoder.hash_lr_multiplier + 1e-6
    near = total = 0
    for name, p in enc.state_dict().items():
        d = (p - want_sd[name]).abs()
        assert d.max().item() <= bound, name
        near += int((d <= 1e-5).sum())
        total += d.numel()
    assert near >= 0.999 * total


def test_stacked_batch_feed_matches_the_reference():
    """A GAN step draws batch_size * (n_critic + 1) examples at once and
    stacks them: the same images and labels as the reference's host feed
    for the same seed and steps."""
    ds, _ = make_synthetic(50, 5, size=8, seed=3)
    cfg = get_config("config2")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=4))
    cfg_j = get_config_jax("config2")
    cfg_j = dataclasses.replace(cfg_j, train=dataclasses.replace(
        cfg_j.train, batch_size=4))
    got = make_batch_feed(ds, cfg, start_step=3, seed=9,
                          device=torch.device("cpu"), n_batches=3)
    want = feed_jax(ds, cfg_j, start_step=3, seed=9, n_batches=3)
    for _ in range(2):
        (gi, gl), (wi, wl) = next(got), next(want)
        assert gi.shape == (3, 4, 8, 8, 3) and gl.shape == (3, 4, 5)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_gan_range_round_trip_is_bit_equal():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16, 1)
    from hashgan_tpu.data import preprocess as prep_jax

    x = to_gan_range(torch.from_numpy(u8))
    x_j = prep_jax.to_gan_range(jnp.asarray(u8))
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_j))
    np.testing.assert_array_equal(from_gan_range(x).numpy(),
                                  np.asarray(prep_jax.from_gan_range(x_j)))
    y = torch.linspace(-1.2, 1.2, 97)
    np.testing.assert_array_equal(
        from_gan_range(y).numpy(),
        np.asarray(prep_jax.from_gan_range(jnp.asarray(y.numpy()))))


@pytest.mark.parametrize("multi", [False, True])
def test_sample_quality_numbers_match(multi):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((40, 6)) * 2).astype(np.float32)
    labels = (np.eye(6, dtype=np.float32)[rng.integers(0, 6, 40)]
              if not multi else (rng.random((40, 6)) < 0.3).astype(np.float32))
    np.testing.assert_allclose(
        sq.inception_score_from_logits(logits, splits=2),
        sq_jax.inception_score_from_logits(jnp.asarray(logits), splits=2),
        rtol=1e-5)
    assert sq.conditional_accuracy(logits, labels, multi) == \
        sq_jax.conditional_accuracy(logits, labels, multi)

    # the report: K classes cycled over the samples; a classifier that
    # reads the class off the image scores every sample right
    def gen(z, y):
        return y[:, None, None, :6].expand(-1, 2, 2, 6) * 2 - 1

    report = sq.sample_quality_report(
        gen, lambda x: x.mean(dim=(1, 2)) * 10, seed=7, n_labels=6, z_dim=3,
        device="cpu", n_samples=24, batch=8, key_suffix="_x")
    assert report["conditional_accuracy_x"] == 1.0
    assert report["marginal_label_entropy_bits_x"] == pytest.approx(
        np.log2(6), abs=1e-3)


def test_template_classifier_matches_the_reference():
    rng = np.random.default_rng(2)
    templates = rng.uniform(0, 255, (5, 8, 8, 3)).astype(np.float32)
    images = rng.uniform(-1, 1, (7, 8, 8, 3)).astype(np.float32)
    got = sq.make_template_classifier(templates)(torch.from_numpy(images))
    want = sq_jax.make_template_classifier(templates)(jnp.asarray(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("channels,n,cols", [(3, 10, 0), (1, 5, 2),
                                             (3, 64, 0)])
def test_save_image_grid_pixels_match_the_reference(tmp_path, channels, n,
                                                    cols):
    """The port's own PNG writer: PIL decodes the reference's pixels."""
    from PIL import Image

    rng = np.random.default_rng(channels + n)
    images = rng.uniform(-1, 1, (n, 6, 5, channels)).astype(np.float32)
    save_image_grid(images, str(tmp_path / "a.png"), n_cols=cols)
    save_grid_jax(images, str(tmp_path / "b.png"), n_cols=cols)
    got = np.asarray(Image.open(tmp_path / "a.png"))
    want = np.asarray(Image.open(tmp_path / "b.png"))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", ["configs/cifar10_step1.yaml",
                                  "configs/nuswide_step1.yaml",
                                  "config2_cal", "config3_cal",
                                  "cifar10_48bit_gan_cal", "config2",
                                  "config4"])
def test_gan_configs_load_with_the_reference_values(spec):
    """Every field the port's config has equals the reference's, for the
    stage-1 yamls and the GAN presets (the workdir default differs on
    purpose)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if spec.endswith(".yaml"):
        got = load_yaml(os.path.join(repo, spec))
        want = load_yaml_jax(os.path.join(repo, spec))
    else:
        got, want = get_config(spec), get_config_jax(spec)
    assert got.name == want.name and got.use_gan == want.use_gan
    for section in ("data", "gan", "encoder", "hash_loss", "train", "index",
                    "eval"):
        ours = getattr(got, section)
        for f in dataclasses.fields(ours):
            if section == "train" and f.name == "workdir" and \
                    not spec.endswith(".yaml"):
                continue
            assert getattr(ours, f.name) == getattr(
                getattr(want, section), f.name), (section, f.name)
    assert dataclasses.asdict(got.gan) == dataclasses.asdict(want.gan)


def _tiny_exp_cfg(tmp_path, **train):
    cfg = _tiny(get_config("config2"), ema_decay=0.9)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **{
        "log_every": 2, "sample_every": 3, "checkpoint_every": 2,
        "eval_every": 10**6, "workdir": str(tmp_path), **train}))


def _gan_tensors(st):
    out = dict(st.generator.state_dict())
    out.update({f"d.{k}": v for k, v in st.discriminator.state_dict().items()})
    out.update({f"ema.{k}": v for k, v in st.g_ema.items()})
    out.update({f"ema_stats.{k}": v for k, v in st.g_ema_stats.items()})
    for name, opt in (("g", st.g_opt), ("d", st.d_opt)):
        for i, s in opt.state_dict()["state"].items():
            for key in ("exp_avg", "exp_avg_sq", "step"):
                out[f"{name}opt.{i}.{key}"] = s[key]
    return out


def test_train_gan_boundaries_and_resume(tmp_path):
    """Logs at every log_every, sample grids and sample quality at every
    sample_every, checkpoints at every checkpoint_every (step = encoder +
    GAN step); 3 cycles, save, restore in a new Experiment, 3 more: the
    very state of 6 straight cycles, EMA included."""
    cfg = _tiny_exp_cfg(tmp_path / "a")
    straight = Experiment(cfg, device="cpu")
    means = straight.train_gan(6)
    assert straight.gan_state.step == 6 and straight.encoder_state.step == 0
    assert {"wasserstein", "grad_penalty", "d_aux_ce", "d_loss", "g_loss",
            "g_adv", "g_aux_ce"} == set(means)
    wd = tmp_path / "a"
    assert (wd / "samples_3.png").exists() and (wd / "samples_6.png").exists()
    assert straight.ckpt.all_steps() == [2, 4, 6]
    with open(wd / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [2, 4, 6]
    quality = {"inception_score_aux", "conditional_accuracy_aux",
               "marginal_label_entropy_bits_aux", "inception_score_tmpl",
               "conditional_accuracy_tmpl", "marginal_label_entropy_bits_tmpl"}
    # step 3's report is flushed with step 4's log; step 6's waits
    assert not quality & set(recs[0]) and not quality & set(recs[2])
    assert quality <= set(recs[1])
    assert all(np.isfinite(recs[1][k]) for k in quality)

    cfg_b = _tiny_exp_cfg(tmp_path / "b", checkpoint_every=10**6)
    first = Experiment(cfg_b, device="cpu")
    first.train_gan(3)
    first.save_checkpoint()
    resumed = Experiment(cfg_b, device="cpu")
    assert resumed.restore_checkpoint() and resumed.gan_state.step == 3
    resumed.train_gan(3)
    a, b = _gan_tensors(straight.gan_state), _gan_tensors(resumed.gan_state)
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_checkpoint_migrations(tmp_path):
    """A checkpoint with an EMA of G's weights but none of its statistics
    seeds them from the restored statistics; one without a GAN entry (the
    port's checkpoints before stage I) keeps the fresh GAN state."""
    cfg = _tiny_exp_cfg(tmp_path, checkpoint_every=10**6)
    exp = Experiment(cfg, device="cpu")
    exp.train_gan(2)
    exp.save_checkpoint()
    path = os.path.join(exp.ckpt.directory, "ckpt_2.pt")
    saved = torch.load(path, weights_only=True)
    saved["gan"]["g_ema_stats"] = None
    torch.save(saved, path)
    back = Experiment(cfg, device="cpu")
    assert back.restore_checkpoint() and back.gan_state.step == 2
    for name, buf in back.gan_state.generator.named_buffers():
        assert torch.equal(back.gan_state.g_ema_stats[name], buf), name
    for name, e in back.gan_state.g_ema.items():
        assert torch.equal(e, saved["gan"]["g_ema"][name]), name

    del saved["gan"]
    torch.save(saved, path)
    fresh = Experiment(cfg, device="cpu")
    want = create_gan_state(cfg, "cpu").generator.state_dict()
    assert fresh.restore_checkpoint() and fresh.gan_state.step == 0
    for name, v in fresh.gan_state.generator.state_dict().items():
        assert torch.equal(v, want[name]), name


def test_cli_stage_branches(tmp_path, monkeypatch, capsys):
    """--stage 1 trains the GAN alone; --stage 2 restores stage I's
    checkpoint (without --resume), co-trains and prints evaluate();
    --stage all trains both from scratch."""
    import yaml

    monkeypatch.setattr(cli, "_mesh",
                        lambda cfg, gpu: Mesh(["cpu"], cfg.mesh.data_axis))
    raw = {"preset": "config2",
           "data": {"n_classes": K, "n_train": 64, "n_query": 8,
                    "n_database": 40},
           "gan": {"dim": 8, "z_dim": Z, "n_critic": NC,
                   "compute_dtype": "float32"},
           "encoder": {"arch": "small_cnn", "bits": 32,
                       "compute_dtype": "float32"},
           "train": {"batch_size": B, "log_every": 1, "sample_every": 10**6,
                     "checkpoint_every": 1, "eval_every": 10**6,
                     "workdir": str(tmp_path / "wd")},
           "eval": {"R": 20}}
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(raw))
    steps = lambda wd: Experiment(load_yaml(str(path)), workdir=str(wd),  # noqa: E731
                                  device="cpu").ckpt.all_steps()

    cli.main(["train", "--config", str(path), "--stage", "1", "--iters", "2"])
    out = capsys.readouterr()
    assert not any(line.startswith("{") for line in out.out.splitlines())
    assert steps(tmp_path / "wd") == [1, 2]
    cli.main(["train", "--config", str(path), "--stage", "2", "--iters", "1"])
    out = capsys.readouterr()
    assert "restored stage-1 checkpoint from workdir" in out.err
    assert set(json.loads(out.out.strip().splitlines()[-1])) == {
        "map_at_20", "precision_at_h2"}
    assert steps(tmp_path / "wd") == [1, 2, 3]  # encoder 1 + GAN 2
    cli.main(["train", "--config", str(path), "--stage", "all", "--iters",
              "1", "--workdir", str(tmp_path / "all")])
    out = capsys.readouterr()
    assert "restored" not in out.err
    assert set(json.loads(out.out.strip().splitlines()[-1])) == {
        "map_at_20", "precision_at_h2"}
    assert steps(tmp_path / "all") == [1, 2]


def _record_lrs(st):
    """Each update's lr as the optimiser reads it, D's and G's, in order."""
    seen = []
    for opt in (st.d_opt, st.g_opt):
        opt.register_step_pre_hook(
            lambda o, *_: seen.append(o.param_groups[0]["lr"]))
    return seen


@pytest.mark.parametrize("restored", [False, True])
def test_staged_lrs_follow_the_schedules(tmp_path, restored):
    """``cycle_lrs`` before each cycle (what the graph stages) equals the
    lr each of its n_critic + 1 updates then takes from the decaying
    schedules, in float64, cycle after cycle; and so after a restore in a
    fresh Experiment."""
    cfg = _tiny_exp_cfg(tmp_path, checkpoint_every=10**6)
    exp = Experiment(cfg, device="cpu")
    if restored:
        exp.train_gan(3)
        exp.save_checkpoint()
        exp = Experiment(cfg, device="cpu")
        assert exp.restore_checkpoint() and exp.gan_state.step == 3
    st = exp.gan_state
    seen = _record_lrs(st)
    lrs = []
    for _ in range(3):
        lrs += cycle_lrs(st, cfg)
        exp.train_gan(1)
    assert seen == lrs
    assert len(set(lrs)) > NC + 1  # the decay moved them


@pytest.mark.parametrize("name", ["g", "d"])
def test_capturable_gan_adam_checkpoints_cross(tmp_path, name):
    """A plain GAN Adam's state (two cycles in) loads into a capturable
    one, whose lr stays a float32 tensor and its step counts float32, and
    back into a plain one, whose lr is the float schedule's again: the
    moments, step counts and schedule survive both ways."""
    cfg = _tiny_exp_cfg(tmp_path)
    exp = Experiment(cfg, device="cpu")
    exp.train_gan(2)
    st = exp.gan_state
    opt, sched = getattr(st, f"{name}_opt"), getattr(st, f"{name}_sched")
    plain_lr = opt.param_groups[0]["lr"]
    cap = create_gan_state(cfg, "cpu", capturable=True)
    c_opt, c_sched = getattr(cap, f"{name}_opt"), getattr(cap,
                                                          f"{name}_sched")
    _load_optimizer(c_opt, c_sched, opt.state_dict(), sched.state_dict())
    group = c_opt.param_groups[0]
    assert group["capturable"] and torch.is_tensor(group["lr"])
    assert group["lr"].dtype == torch.float32
    assert float(group["lr"]) == float(torch.tensor(plain_lr,
                                                    dtype=torch.float32))
    back = create_gan_state(cfg, "cpu")
    b_opt, b_sched = getattr(back, f"{name}_opt"), getattr(back,
                                                           f"{name}_sched")
    _load_optimizer(b_opt, b_sched, c_opt.state_dict(), c_sched.state_dict())
    group = b_opt.param_groups[0]
    assert not group["capturable"] and group["lr"] == plain_lr
    assert b_sched.last_epoch == sched.last_epoch
    for c in (c_opt, b_opt):
        for s0, s1 in zip(opt.state.values(), c.state.values()):
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(s0[key], s1[key]), key
            assert float(s1["step"]) == float(s0["step"])
    assert all(s["step"].dtype == torch.float32
               for s in c_opt.state.values())


@pytest.mark.parametrize("n", [1, 2])
def test_gan_cycle_stays_eager_off_the_card(tmp_path, n):
    """On the CPU, at mesh 1 and 2, ``_gan_cycle`` is the eager cycle past
    the graph's warm-up, with plain Adam; the graph refuses such a state."""
    cfg = _tiny_exp_cfg(tmp_path)
    exp = Experiment(cfg, mesh=Mesh(["cpu"] * n))
    calls = []
    eager = exp._eager_gan_cycle
    exp._eager_gan_cycle = lambda *a: calls.append(1) or eager(*a)
    exp.train_gan(WARMUP + 2)
    st = exp.gan_state
    assert len(calls) == WARMUP + 2 and st.step == WARMUP + 2
    assert exp._graphed_gan is None
    for opt in (st.d_opt, st.g_opt):
        assert not opt.param_groups[0]["capturable"]
        assert isinstance(opt.param_groups[0]["lr"], float)
    with pytest.raises(ValueError, match="capturable"):
        GraphedGanCycle(st, cfg)
