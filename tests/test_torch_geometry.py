"""The AlexNet input geometry of the port (``data/preprocess.py``) and its
use in the train step, the encode function and the encoder, against the
reference on the CPU.

- The resize and both geometries: the same NHWC inputs and the
  reference's crop offsets (drawn with its key and fed to the port) give
  the reference's output, computed in float64, within 1e-4 absolute on
  mean-subtracted pixels; and the float32 reference's within its own
  distance from the float64 one plus 1e-4 (``jax.image.resize`` in
  float32 is up to 2.3e-4 off on these inputs, so 1e-4 against it alone
  would test the reference's rounding, not the port). The crops are
  exact.
- One train step at ``input_resize > 0`` against the reference's
  ``make_encoder_train_step`` with its flip, crop, geometry offsets and z
  fed to the port: the loss metrics within rtol 1e-4 (atol 1e-5), and
  each parameter's gradient within rtol 1e-4 of the reference's with an
  atol of 1e-4 times that tensor's largest gradient (the gradients are
  float32 sums in another order; 1e-4 of the largest entry is far below
  an Adam step's sign). The reference returns no gradients, so the test
  rebuilds its step's input from the same keys, checks that its loss is
  the step's, and differentiates that loss. SmallCNN at 16 -> 24 with
  fakes from a one-layer generator, and AlexNet at 227 (fc6 at 9,216
  inputs) on 4 images with dropout off (its masks are drawn differently).
- The encode function with the evaluation geometry, and AlexNet's in-model
  resize of raw 32x32 inputs: codes within 1e-4 (the float32 tolerance of
  tests/test_torch_encoder.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from hashgan_tpu.configs import get_config as get_config_jax
from hashgan_tpu.data import preprocess as pre_jax
from hashgan_tpu.losses.pairwise import wml_pairwise_loss as loss_jax
from hashgan_tpu.models.alexnet import AlexNetEncoder as FlaxAlexNet
from hashgan_tpu.models.encoders import SmallCNNEncoder as FlaxSmallCNN
from hashgan_tpu.train.hash_step import make_encode_fn as make_encode_jax
from hashgan_tpu.train.hash_step import make_encoder_train_step as step_jax
from hashgan_tpu.train.state import EncoderState as EncoderStateJax
from hashgan_tpu.train.state import make_encoder_tx as make_tx_jax
from hashgan_tpu_torch.configs import get_config
from hashgan_tpu_torch.data.preprocess import (
    alexnet_eval_geometry,
    alexnet_train_geometry,
    center_crop,
    random_crop_to,
    resize_images,
    step_generator,
)
from hashgan_tpu_torch.models.alexnet import AlexNetEncoder
from hashgan_tpu_torch.models.convert import flax_to_torch
from hashgan_tpu_torch.models.encoders import SmallCNNEncoder
from hashgan_tpu_torch.train.hash_step import (
    make_encode_fn,
    make_encoder_train_step,
)
from hashgan_tpu_torch.train.state import EncoderState, make_encoder_tx

from torch_threads import one_thread  # noqa: F401

TOL = 1e-4
K = 4


def _pixels(b, side, seed):
    """Mean-subtracted float32 pixels, as ``to_encoder_input`` makes them."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, side, side, 3)).astype(np.float32)
            - np.float32(120.0))


def _images(b, side, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, side, side, 3),
                                                dtype=np.uint8)


def _reference(fn, x, *args, x64):
    """``fn`` of the reference on ``x`` in float32, or with 64-bit types
    on and ``x`` in float64."""
    with jax.enable_x64(x64):
        return np.asarray(fn(jnp.asarray(
            x.astype(np.float64 if x64 else np.float32)), *args))


def _assert_matches(got, want32, want64):
    """Within TOL of the float64 reference, and of the float32 one within
    TOL more than that is off the float64 one."""
    assert got.shape == want32.shape == want64.shape
    np.testing.assert_allclose(got, want64, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, want32, rtol=0,
                               atol=TOL + np.abs(want32 - want64).max())


@pytest.mark.parametrize("side,size", [(16, 24), (16, 28), (32, 256),
                                       (32, 227), (256, 227), (24, 16),
                                       (16, 16)])
def test_resize_matches_the_reference(side, size):
    """Up from 16 and 32 to the geometry's sides, and down (antialiased)."""
    x = _pixels(3, side, seed=side + size)
    got = resize_images(torch.from_numpy(x), size).numpy()
    assert got.shape == (3, size, size, 3) and got.dtype == np.float32
    _assert_matches(got, *(_reference(pre_jax.resize_images, x, size,
                                      x64=x64) for x64 in (False, True)))


@pytest.mark.parametrize("side,size", [(28, 24), (256, 227), (27, 24),
                                       (24, 24)])
def test_crops_match_the_reference(side, size):
    """The central crop, and the random crop at the reference's offsets
    (one per example, on the diagonal), are exact."""
    x = _pixels(5, side, seed=side)
    np.testing.assert_array_equal(
        center_crop(torch.from_numpy(x), size).numpy(),
        np.asarray(pre_jax.center_crop(jnp.asarray(x), size)))
    key = jax.random.key(side)
    want = np.asarray(pre_jax.random_crop_to(key, jnp.asarray(x), size))
    offsets = np.asarray(jax.random.randint(key, (5,), 0, side - size + 1))
    got = random_crop_to(None, torch.from_numpy(x), size,
                         offsets=torch.from_numpy(offsets))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = random_crop_to(step_generator(0, side), torch.from_numpy(x), size)
    for i in range(5):  # the port's own draws are on the diagonal as well
        assert any(torch.equal(drawn[i], torch.from_numpy(
            x[i, r:r + size, r:r + size])) for r in range(side - size + 1))


@pytest.mark.parametrize("side,input_resize,resize_base",
                         [(16, 24, 28), (16, 24, 0), (32, 227, 256),
                          (32, 227, 0)])
def test_geometries_match_the_reference(side, input_resize, resize_base):
    """The training geometry at the reference's offsets of its key (drawn
    in float32 mode; the float64 reference crops at the same offsets), and
    the evaluation geometry."""
    x = _pixels(2, side, seed=input_resize)
    key = jax.random.key(resize_base)
    base = max(resize_base, input_resize)
    offsets = np.asarray(jax.random.randint(key, (2,), 0,
                                            base - input_resize + 1))
    got = alexnet_train_geometry(None, torch.from_numpy(x), input_resize,
                                 resize_base,
                                 offsets=torch.from_numpy(offsets)).numpy()
    assert got.shape == (2, input_resize, input_resize, 3)
    want32 = _reference(lambda v: pre_jax.alexnet_train_geometry(
        key, v, input_resize, resize_base), x, x64=False)
    resized = _reference(pre_jax.resize_images, x, base, x64=True)
    want64 = np.stack([resized[i, r:r + input_resize, r:r + input_resize]
                       for i, r in enumerate(offsets)])
    _assert_matches(got, want32, want64)
    got = alexnet_eval_geometry(torch.from_numpy(x), input_resize,
                                resize_base).numpy()
    _assert_matches(got, *(_reference(
        pre_jax.alexnet_eval_geometry, x, input_resize, resize_base, x64=x64)
        for x64 in (False, True)))


class _OneLayerG(nn.Module):
    """A generator of the reference's call signature: tanh of one dense
    layer of [z, labels], as ``side`` x ``side`` RGB images."""

    side: int

    @nn.compact
    def __call__(self, z, labels, train=False):
        h = nn.Dense(self.side * self.side * 3, name="out")(
            jnp.concatenate([z, labels], axis=-1))
        return jnp.tanh(h).reshape(-1, self.side, self.side, 3)


def _torch_sampler(g_params, side):
    w = torch.from_numpy(np.asarray(g_params["out"]["kernel"]))
    b = torch.from_numpy(np.asarray(g_params["out"]["bias"]))

    def sample(z, labels):
        h = torch.cat([z, labels], dim=-1) @ w + b
        return torch.tanh(h).reshape(-1, side, side, 3)

    return sample


def _fill(shapes, seed):
    """Seeded float32 values for a Flax parameter tree (Flax's own init of
    AlexNet at 227 compiles slowly on the CPU): kernels at 1 / sqrt(fan-in),
    biases small, norm scales near 1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return noise / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return np.float32(path[-1].key == "scale") + np.float32(0.05) * noise

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _config(arch, side, input_resize, resize_base, crop_pad, gan, bits):
    """Both packages' configs: ``arch`` at ``bits``, float32, 10x hash lr,
    ``side``-pixel images, the geometry and the crop as given; with
    ``gan``, half a batch of generated images (z of 8)."""
    out = []
    for cfg in (get_config_jax("config2"), get_config("config2")):
        out.append(dataclasses.replace(
            cfg, use_gan=gan,
            data=dataclasses.replace(cfg.data, n_classes=K, image_size=side),
            gan=dataclasses.replace(cfg.gan, z_dim=8),
            encoder=dataclasses.replace(
                cfg.encoder, arch=arch, bits=bits, compute_dtype="float32",
                input_resize=input_resize, resize_base=resize_base),
            train=dataclasses.replace(cfg.train, crop_pad=crop_pad,
                                      use_gan_samples=gan)))
    return out


def _step_against_the_reference(f_enc, t_enc, params, cfg_j, cfg, n, side,
                                gan):
    """One step of each package on the same batch, the reference's draws
    fed to the port. Returns (port metrics, reference metrics, port
    gradients, reference gradients by torch name)."""
    rng = np.random.default_rng(7)
    images = _images(n, side, seed=8)
    labels = np.eye(K, dtype=np.float32)[rng.integers(0, K, n)]
    n_fake = max(1, int(n * cfg.train.fake_ratio)) if gan else 0
    g, g_params = None, None
    if gan:
        g = _OneLayerG(side)
        g_params = _fill(jax.eval_shape(lambda: g.init(
            jax.random.key(0), jnp.zeros((1, 8)), jnp.zeros((1, K))))[
                "params"], 3)
    rng0 = jax.random.key(5)
    state_j = EncoderStateJax(params=params,
                              opt_state=make_tx_jax(cfg_j.encoder).init(params),
                              step=jnp.zeros((), jnp.int32))
    _, want_m = step_jax(f_enc, cfg_j, generator=g)(
        state_j, jnp.asarray(images), jnp.asarray(labels), rng0, g_params, {})

    # the reference's draws (hash_step.py:58-98) and the input they make
    r_flip, r_crop, r_drop, r_z = jax.random.split(
        jax.random.fold_in(rng0, 0), 4)
    pad, enc = cfg.train.crop_pad, cfg.encoder
    flip = np.array(jax.random.bernoulli(r_flip, 0.5, (n, 1, 1, 1))).ravel()
    crop = np.array(jax.random.randint(r_crop, (n,), 0, 2 * pad + 1))
    z = np.array(jax.random.normal(r_z, (n_fake, 8)))
    base = max(enc.resize_base, enc.input_resize)
    r_geo = jax.random.fold_in(r_crop, 1)
    geometry = np.array(jax.random.randint(r_geo, (n + n_fake,), 0,
                                           base - enc.input_resize + 1))
    x = pre_jax.random_flip(r_flip, pre_jax.to_encoder_input(
        jnp.asarray(images)))
    if pad:
        x = pre_jax.random_crop(r_crop, x, pad=pad)
    all_labels = jnp.asarray(labels)
    if gan:
        fake = g.apply({"params": g_params}, jnp.asarray(z),
                       all_labels[:n_fake])
        x = jnp.concatenate([x, pre_jax.gan_to_encoder_input(fake)])
        all_labels = jnp.concatenate([all_labels, all_labels[:n_fake]])
    if enc.input_resize:
        x = pre_jax.alexnet_train_geometry(r_geo, x, enc.input_resize,
                                           enc.resize_base)
    hl = cfg_j.hash_loss

    def loss_fn(p):
        codes = f_enc.apply({"params": p}, x, train=True,
                            rngs={"dropout": r_drop})
        return loss_jax(codes, all_labels, alpha=hl.alpha,
                        similarity=hl.similarity,
                        class_balance=hl.class_balance,
                        class_balance_cap=hl.class_balance_cap,
                        class_balance_mode=hl.class_balance_mode,
                        quantization_weight=hl.quantization_weight,
                        balance_weight=hl.balance_weight)

    (_, rebuilt_m), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    for k, v in want_m.items():  # the rebuilt input is the step's
        np.testing.assert_allclose(float(rebuilt_m[k]), float(v), rtol=1e-6,
                                   atol=1e-7, err_msg=k)

    t_enc.load_state_dict(flax_to_torch(params))
    opt, sched = make_encoder_tx(t_enc, cfg.encoder)
    state = EncoderState(t_enc, opt, sched)
    got_m = make_encoder_train_step(cfg)(
        state, torch.from_numpy(images), torch.from_numpy(labels),
        sample=_torch_sampler(g_params, side) if gan else None,
        flip=torch.from_numpy(flip), z=torch.from_numpy(z),
        crop=torch.from_numpy(crop), geometry=torch.from_numpy(geometry))
    got_g = {name: p.grad for name, p in t_enc.named_parameters()}
    return got_m, want_m, got_g, flax_to_torch(jax.device_get(grads))


def _assert_step_close(got_m, want_m, got_g, want_g):
    assert set(got_m) == set(want_m)
    for k, v in want_m.items():
        np.testing.assert_allclose(got_m[k].item(), float(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert set(got_g) == set(want_g)
    for name, want in want_g.items():
        want = want.numpy()
        np.testing.assert_allclose(got_g[name].numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("input_resize,resize_base", [(0, 0), (24, 28),
                                                      (24, 0)])
def test_small_cnn_step_matches_the_reference(input_resize, resize_base):
    """SmallCNN on 8 real 16x16 images and 4 generated ones, flip and
    crop_pad 2, and the geometry where set: the crop alone at (0, 0)."""
    cfg_j, cfg = _config("small_cnn", 16, input_resize, resize_base, 2,
                         True, 32)
    f_enc = FlaxSmallCNN(bits=32, dim=16)
    side = input_resize or 16
    params = jax.device_get(jax.jit(lambda: f_enc.init(
        jax.random.key(2), jnp.zeros((1, side, side, 3)),
        train=False))()["params"])
    _assert_step_close(*_step_against_the_reference(
        f_enc, SmallCNNEncoder(bits=32, dim=16), params, cfg_j, cfg, 8, 16,
        True))


@pytest.fixture(scope="module")
def alexnet_227():
    """Flax AlexNet (48 bits, dropout off, input_resize 227) with seeded
    weights, and the port's of the same config."""
    f_enc = FlaxAlexNet(bits=48, dropout_rate=0.0, input_resize=227)
    params = _fill(jax.eval_shape(lambda: f_enc.init(
        jax.random.key(0), jnp.zeros((1, 227, 227, 3)),
        train=False))["params"], 4)
    t_enc = AlexNetEncoder(bits=48, image_size=32, dropout_rate=0.0,
                           input_resize=227)
    assert params["fc6"]["kernel"].shape[0] == t_enc.fc6.in_features == 9216
    return f_enc, params, t_enc


def test_alexnet_227_step_matches_the_reference(alexnet_227):
    """cifar10_step2's geometry (32 -> 256 -> 227) on 4 real images with
    crop_pad 2, fc6 at bvlc's 9,216 inputs."""
    f_enc, params, t_enc = alexnet_227
    cfg_j, cfg = _config("alexnet", 32, 227, 256, 2, False, 48)
    _assert_step_close(*_step_against_the_reference(
        f_enc, t_enc, params, cfg_j, cfg, 4, 32, False))


def test_encode_geometry_matches_the_reference(alexnet_227):
    """``make_encode_fn`` with the evaluation geometry (SmallCNN 16 -> 28
    -> 24; AlexNet 32 -> 256 -> 227), and AlexNet resizing raw 32x32
    inputs to 227 itself (no geometry)."""
    f_enc, params, t_enc = alexnet_227
    f_small = FlaxSmallCNN(bits=32, dim=16)
    p_small = jax.device_get(f_small.init(
        jax.random.key(3), jnp.zeros((1, 24, 24, 3)), train=False)["params"])
    t_small = SmallCNNEncoder(bits=32, dim=16)
    t_small.load_state_dict(flax_to_torch(p_small))
    t_enc.load_state_dict(flax_to_torch(params))
    for f, p, t, arch, bits, side, size, base, n in (
            (f_small, p_small, t_small, "small_cnn", 32, 16, 24, 28, 6),
            (f_enc, params, t_enc, "alexnet", 48, 32, 227, 256, 2)):
        cfg_j, cfg = _config(arch, side, size, base, 0, False, bits)
        images = _images(n, side, seed=size)
        want = np.asarray(make_encode_jax(f, cfg_j)(p, jnp.asarray(images)))
        got = make_encode_fn(t, cfg)(images).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=arch)
        assert np.abs(want).max() > 10 * TOL
    images = _images(2, 32, seed=9)
    want = np.asarray(make_encode_jax(f_enc)(params, jnp.asarray(images)))
    got = make_encode_fn(t_enc)(images).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
