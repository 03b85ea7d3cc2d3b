"""The PC-WGAN training cycle and sampling (port of
``hashgan_tpu/train/gan_step.py``).

One cycle is ``n_critic`` critic steps, on batches ``0 .. n_critic - 1`` of
a stacked ``(n_critic + 1, B, H, W, C)`` uint8 tensor, then one generator
step on batch ``n_critic`` with its labels. The critic's fakes come from G
in train mode (batch statistics), carry no gradient, and leave G's running
averages as they were; only the generator step advances them. The critic
loss's gradient penalty is a double backward (``losses/wgan_gp.py``).

A cycle's random draws (z for each critic step, the penalty's interpolation
weights, z for the generator step) come from a CPU ``torch.Generator``
seeded from (seed, GAN step) with a tag of its own, so a cycle is a pure
function of its inputs and a resumed run repeats it. They are not the
reference's ``jax.random`` bits: the parity tests rebuild those and pass
them in as ``draws``.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from hashgan_tpu_torch.data.preprocess import _on, to_gan_range
from hashgan_tpu_torch.losses.wgan_gp import critic_loss_fn, generator_loss_fn
from hashgan_tpu_torch.train.state import GanState

Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_CYCLE_TAG = 0x6A57  # keeps these draws apart from the encoder step's


def cycle_draws(seed: int, step: int, n_critic: int, batch: int,
                z_dim: int) -> Draws:
    """(z for the critic steps (n_critic, B, z_dim), interpolation weights
    (n_critic, B) in [0, 1), z for the generator step (B, z_dim)), float32
    on the CPU, a function of (seed, step)."""
    state = np.random.SeedSequence(
        [seed, step, _CYCLE_TAG]).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(state[0]) & ((1 << 63) - 1))
    z_critic = torch.randn(n_critic, batch, z_dim, generator=gen)
    eps = torch.rand(n_critic, batch, generator=gen)
    return z_critic, eps, torch.randn(batch, z_dim, generator=gen)


def _apply_grads(params, grads, opt, sched) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    if sched is not None:
        sched.step()


def make_gan_cycle(cfg) -> Callable:
    """``cycle(state, images_u8 (n_critic + 1, B, H, W, C), labels
    (n_critic + 1, B, K), draws=None) -> metrics``: updates ``state`` (a
    ``GanState``) in place and returns the last critic step's metrics with
    the generator's, as 0-dim tensors on the device (with ``d_projection``
    also ``wasserstein_noproj``, the base critic's estimate on the generator
    step's batch). ``draws`` defaults to ``cycle_draws(cfg.train.seed,
    state.step, ...)``."""
    gan, multi, seed = cfg.gan, cfg.data.multi_label, cfg.train.seed
    nc = gan.n_critic

    def cycle(state: GanState, images_u8: torch.Tensor, labels: torch.Tensor,
              draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        g, d = state.generator, state.discriminator
        dev = images_u8.device
        if draws is None:
            draws = cycle_draws(seed, state.step, nc, images_u8.shape[1],
                                gan.z_dim)
        z_critic, eps, z_g = (_on(t, dev) for t in draws)
        d_params = list(d.parameters())
        for k in range(nc):
            labs = labels[k]
            with torch.no_grad():
                fake = g(z_critic[k], labs, train=True, update=False)
            loss, d_metrics = critic_loss_fn(
                d, to_gan_range(images_u8[k]),
                fake, labs, eps[k], gp_lambda=gan.gp_lambda,
                acgan_scale=gan.acgan_scale,
                acgan_fake_scale=gan.acgan_fake_scale, multi_label=multi)
            _apply_grads(d_params, torch.autograd.grad(loss, d_params),
                         state.d_opt, state.d_sched)

        labs_g = labels[nc]
        fake = g(z_g, labs_g, train=True, update=True)
        loss, g_metrics = generator_loss_fn(
            d, fake, labs_g,
            acgan_scale_g=gan.acgan_scale_g, multi_label=multi)
        g_params = list(g.parameters())
        _apply_grads(g_params, torch.autograd.grad(loss, g_params),
                     state.g_opt, state.g_sched)

        if gan.ema_decay > 0 and state.g_ema is not None:
            # the running averages move at the same horizon, so sampling
            # with EMA weights normalises with statistics that match them
            with torch.no_grad():
                for ema, live in (
                        (state.g_ema, dict(g.named_parameters())),
                        (state.g_ema_stats, dict(g.named_buffers()))):
                    e = list(ema.values())
                    torch._foreach_mul_(e, gan.ema_decay)
                    torch._foreach_add_(e, torch._foreach_mul(
                        [live[k] for k in ema], 1.0 - gan.ema_decay))
        state.step += 1

        metrics = {k: v.detach() for k, v in d_metrics.items()}
        metrics.update({k: v.detach() for k, v in g_metrics.items()})
        if gan.d_projection:
            with torch.no_grad():
                fake = g(z_g, labs_g, train=True, update=False)
                base_real, _ = d(to_gan_range(images_u8[nc]), None)
                base_fake, _ = d(fake, None)
                metrics["wasserstein_noproj"] = (base_real.mean()
                                                 - base_fake.mean())
        return metrics

    return cycle


def sample_images(state: GanState, z: torch.Tensor, labels: torch.Tensor,
                  ema: bool = False) -> torch.Tensor:
    """G's images in [-1, 1] for (z, labels) with its running averages
    (eval mode) and no gradient; with ``ema`` (and an EMA kept), with the
    EMA weights and EMA running averages."""
    g = state.generator
    if ema and state.g_ema is not None:
        g = copy.deepcopy(g)
        g.load_state_dict({**state.g_ema, **state.g_ema_stats})
    with torch.no_grad():
        return g(z, labels, train=False)
