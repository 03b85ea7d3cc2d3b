"""The port's WGAN-GP losses against the reference's
(``hashgan_tpu/losses/wgan_gp.py``), at float32.

The gradient penalty's value and its gradient with respect to the critic's
parameters (a double backward) at the reference's interpolation weights;
the linear critic's closed form; the aux cross-entropy, one-hot and
multi-hot; the critic loss with the ACGAN fake term and the generator loss.
Values within 1e-5 relative, gradients within 1e-4 relative and 1e-5
absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashgan_tpu.losses import wgan_gp as ref
from hashgan_tpu.models.gan import Discriminator as FlaxD
from hashgan_tpu_torch.losses.wgan_gp import (
    aux_classification_loss,
    critic_loss_fn,
    generator_loss_fn,
    gradient_penalty,
)
from hashgan_tpu_torch.models.convert import discriminator_flax_to_torch
from hashgan_tpu_torch.models.gan import Discriminator

from torch_threads import one_thread  # noqa: F401

K, B = 4, 6


def _critic(projection):
    """A Flax critic (dim 8, LayerNorm) with seeded parameters and the
    port's copy."""
    fd = FlaxD(image_size=32, n_labels=K, dim=8, use_layernorm=True,
               projection=projection)
    shapes = jax.eval_shape(lambda: fd.init(
        jax.random.key(0), jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, K))))
    rng = np.random.default_rng(5)

    def fill(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return noise / np.sqrt(np.prod(leaf.shape[:-1]))
        return (1.0 if path[-1].key == "scale" else 0.0) + 0.1 * noise

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    td = Discriminator(image_size=32, n_labels=K, dim=8, use_layernorm=True,
                       projection=projection)
    td.load_state_dict(discriminator_flax_to_torch(params))
    return fd, params, td


def _batch(multi=False):
    rng = np.random.default_rng(2)
    real = rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    fake = np.tanh(rng.standard_normal((B, 32, 32, 3))).astype(np.float32)
    if multi:
        labels = (rng.random((B, K)) < 0.4).astype(np.float32)
    else:
        labels = np.eye(K, dtype=np.float32)[rng.integers(0, K, B)]
    return real, fake, labels


def _reference_eps(key):
    """The interpolation weights the reference's penalty draws from ``key``."""
    return np.array(jax.random.uniform(key, (B, 1, 1, 1))).reshape(B)


def _grads_close(td, want_params, what):
    want = discriminator_flax_to_torch(want_params)
    for name, p in td.named_parameters():
        # the aux head does not reach the penalty: no gradient, JAX's zeros
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("projection", [False, True])
def test_gradient_penalty_and_its_gradient_match(projection):
    fd, params, td = _critic(projection)
    real, fake, labels = _batch()
    key = jax.random.key(9)

    def gp_ref(p):
        return ref.gradient_penalty(
            lambda x: fd.apply({"params": p}, x, labels)[0], key, real, fake)

    want, want_g = jax.jit(jax.value_and_grad(gp_ref))(params)
    t_labels = torch.from_numpy(labels)
    got = gradient_penalty(lambda x: td(x, t_labels)[0],
                           torch.from_numpy(real), torch.from_numpy(fake),
                           torch.from_numpy(_reference_eps(key)))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _grads_close(td, jax.device_get(want_g), "d gp /")


def test_gradient_penalty_linear_critic_closed_form():
    """For D(x) = <w, x>, grad_x D = w everywhere, so GP = (||w|| - 1)^2
    whatever the weights."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((4, 4, 3)).astype(np.float32))
    real = torch.from_numpy(rng.standard_normal((8, 4, 4, 3)).astype(np.float32))
    fake = torch.from_numpy(rng.standard_normal((8, 4, 4, 3)).astype(np.float32))
    gp = gradient_penalty(lambda x: (x * w).sum(dim=(1, 2, 3)), real, fake,
                          torch.rand(8, generator=torch.Generator().manual_seed(0)))
    assert abs(gp.item() - (w.norm().item() - 1.0) ** 2) < 1e-4


@pytest.mark.parametrize("multi", [False, True])
def test_aux_classification_loss_matches(multi):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((7, K)) * 3).astype(np.float32)
    if multi:
        labels = (rng.random((7, K)) < 0.5).astype(np.float32)
    else:
        labels = np.eye(K, dtype=np.float32)[rng.integers(0, K, 7)]
    want = float(ref.aux_classification_loss(jnp.asarray(logits),
                                             jnp.asarray(labels), multi))
    got = aux_classification_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels), multi).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if not multi:  # the hand-computed pair of the reference's own test
        got = aux_classification_loss(torch.tensor([[2.0, 1.0, 0.0],
                                                    [0.0, 0.0, 0.0]]),
                                      torch.tensor([[1.0, 0.0, 0.0],
                                                    [0.0, 1.0, 0.0]])).item()
        p0 = np.exp(2.0) / (np.exp(2.0) + np.exp(1.0) + 1.0)
        assert abs(got - (-np.log(p0) - np.log(1.0 / 3.0)) / 2.0) < 1e-6


@pytest.mark.parametrize("multi,projection", [(False, True), (True, False)])
def test_critic_and_generator_losses_match(multi, projection):
    """The critic loss with the aux CE on fakes (acgan_fake_scale 0.5) and
    the generator loss: every metric, and the critic loss's gradient."""
    fd, params, td = _critic(projection)
    real, fake, labels = _batch(multi)
    key = jax.random.key(3)
    kw = dict(gp_lambda=10.0, acgan_scale=1.0, acgan_fake_scale=0.5,
              multi_label=multi)

    def d_loss_ref(p):
        return ref.critic_loss_fn(
            lambda x: fd.apply({"params": p}, x, labels), key, real, fake,
            labels, **kw)

    (_, want_m), want_g = jax.jit(jax.value_and_grad(
        d_loss_ref, has_aux=True))(params)
    t = {k: torch.from_numpy(v) for k, v in
         dict(real=real, fake=fake, labels=labels).items()}
    loss, got_m = critic_loss_fn(td, t["real"], t["fake"], t["labels"],
                                 torch.from_numpy(_reference_eps(key)), **kw)
    loss.backward()
    assert set(got_m) == set(want_m) and "d_aux_ce_fake" in got_m
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _grads_close(td, jax.device_get(want_g), "d loss /")

    _, want_g_m = ref.generator_loss_fn(
        lambda x: fd.apply({"params": params}, x, labels), fake, labels,
        acgan_scale_g=0.1, multi_label=multi)
    _, got_g_m = generator_loss_fn(td, t["fake"], t["labels"],
                                   acgan_scale_g=0.1, multi_label=multi)
    assert set(got_g_m) == set(want_g_m) == {"g_loss", "g_adv", "g_aux_ce"}
    for k in want_g_m:
        np.testing.assert_allclose(got_g_m[k].item(), float(want_g_m[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
