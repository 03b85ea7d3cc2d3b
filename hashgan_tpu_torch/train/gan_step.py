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

Under a data-parallel mesh (``make_gan_cycle(cfg, mesh)``, the reference's
cycle on a batch sharded along dim 1 of its stack) each mesh position runs
its rows on its replicas of G and D (``parallel/data_parallel.py``). The
draws stay the global batch's and are split by rows. G runs in lock-step
over the positions, its batch norms over the global batch
(``models/gan.py::generator_shards``); the critic, its gradient penalty
included (a double backward per position), runs on each position alone, as
it treats each sample alone. The scores, aux logits and penalty terms are
gathered on the first position, so every mean is over the global batch;
the gradients are summed there, the master's optimisers step, and the EMA
moves once. At one position this is the single-device cycle.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from hashgan_tpu_torch.data.preprocess import to_gan_range
from hashgan_tpu_torch.losses.wgan_gp import (
    critic_loss_from_parts,
    critic_parts,
    generator_loss_from_parts,
)
from hashgan_tpu_torch.models.gan import generator_shards
from hashgan_tpu_torch.parallel.data_parallel import (
    ReplicaSet,
    gather_rows,
    replica_cache,
    shard_rows,
)
from hashgan_tpu_torch.parallel.mesh import Mesh
from hashgan_tpu_torch.train.state import GanState
from hashgan_tpu_torch.utils.profiling import count, span

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


# the spans of each network's backward and update
_CRITIC = ("gan.critic.backward", "gan.critic.optim")
_GENERATOR = ("gan.generator.backward", "gan.generator.optim")


def _apply_grads(params, grads, opt, sched) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    if sched is not None:
        sched.step()


def _step(replicas: ReplicaSet, loss: torch.Tensor, opt, sched,
          spans: Tuple[str, str]) -> None:
    """Every position's gradients of ``loss``, summed on the master, and
    the master's update."""
    with span(spans[0]):
        grads = replicas.reduce(torch.autograd.grad(loss,
                                                    replicas.parameters()))
    with span(spans[1]):
        _apply_grads(list(replicas.master.parameters()), grads, opt, sched)


def _gathered(parts) -> Tuple[torch.Tensor, ...]:
    """Per-position tuples of values -> the values of the global batch."""
    return tuple(gather_rows(list(p)) for p in zip(*parts))


def make_gan_cycle(cfg, mesh: Optional[Mesh] = None) -> Callable:
    """``cycle(state, images_u8 (n_critic + 1, B, H, W, C), labels
    (n_critic + 1, B, K), draws=None) -> metrics``: updates ``state`` (a
    ``GanState``) in place and returns the last critic step's metrics with
    the generator's, as 0-dim tensors on the (first) device (with
    ``d_projection`` also ``wasserstein_noproj``, the base critic's
    estimate on the generator step's batch). ``draws`` defaults to
    ``cycle_draws(cfg.train.seed, state.step, ...)``.

    With a ``mesh`` of more than one position the cycle is data-parallel:
    ``images_u8`` and ``labels`` are the global stacks (split along dim 1,
    which the mesh must divide) or one (n_critic + 1, B / n, ...) chunk a
    position, on its device (a sharded feed's); the state's modules lie on
    the mesh's first device."""
    gan, multi, seed = cfg.gan, cfg.data.multi_label, cfg.train.seed
    nc = gan.n_critic
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    g_replicas, d_replicas = replica_cache(mesh), replica_cache(mesh)
    loss_kw = dict(gp_lambda=gan.gp_lambda, acgan_scale=gan.acgan_scale,
                   acgan_fake_scale=gan.acgan_fake_scale, multi_label=multi)

    def cycle(state: GanState, images_u8, labels,
              draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        with span("gan.cycle", state.step):
            count("train.steps")
            return _cycle(state, images_u8, labels, draws)

    def _cycle(state: GanState, images_u8, labels,
               draws: Optional[Draws]) -> Dict[str, torch.Tensor]:
        gs, ds = g_replicas(state.generator), d_replicas(state.discriminator)
        devs = gs.devices
        images = shard_rows(devs, images_u8, dim=1)
        labs = shard_rows(devs, labels, dim=1)
        if draws is None:
            draws = cycle_draws(seed, state.step, nc,
                                sum(x.shape[1] for x in images), gan.z_dim)
        z_critic, eps, z_g = (shard_rows(devs, draws[0], dim=1),
                              shard_rows(devs, draws[1], dim=1),
                              shard_rows(devs, draws[2]))
        gs.sync()
        for k in range(nc):
            ds.sync()
            labs_k = [y[k] for y in labs]
            with span("gan.critic.forward"):
                with torch.no_grad():
                    fakes = generator_shards(
                        gs.modules, [z[k] for z in z_critic], labs_k,
                        train=True, update=False)
                parts = _gathered(
                    critic_parts(d, to_gan_range(x[k]), f, y, e[k])
                    for d, x, f, y, e in zip(ds.modules, images, fakes,
                                             labs_k, eps))
                loss, d_metrics = critic_loss_from_parts(
                    *parts, gather_rows(labs_k), **loss_kw)
            _step(ds, loss, state.d_opt, state.d_sched, _CRITIC)

        ds.sync()
        labs_g = [y[nc] for y in labs]
        with span("gan.generator.forward"):
            fakes = generator_shards(gs.modules, z_g, labs_g, train=True,
                                     update=True)
            d_fake, aux_fake = _gathered(
                d(f, y) for d, f, y in zip(ds.modules, fakes, labs_g))
            loss, g_metrics = generator_loss_from_parts(
                d_fake, aux_fake, gather_rows(labs_g),
                acgan_scale_g=gan.acgan_scale_g, multi_label=multi)
        _step(gs, loss, state.g_opt, state.g_sched, _GENERATOR)

        g = state.generator
        if gan.ema_decay > 0 and state.g_ema is not None:
            # the running averages move at the same horizon, so sampling
            # with EMA weights normalises with statistics that match them
            with span("gan.ema.optim"), torch.no_grad():
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
            gs.sync()
            with torch.no_grad():
                fakes = generator_shards(gs.modules, z_g, labs_g, train=True,
                                         update=False)
                base_real, base_fake = _gathered(
                    (d(to_gan_range(x[nc]), None)[0], d(f, None)[0])
                    for d, x, f in zip(ds.modules, images, fakes))
                metrics["wasserstein_noproj"] = (base_real.mean()
                                                 - base_fake.mean())
        return metrics

    return cycle


def eval_sampler(g) -> Callable:
    """``sample(z, labels)``: ``g``'s images in [-1, 1] in eval mode (its
    running averages), without a gradient."""

    def sample(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return g(z, labels, train=False)

    return sample


def sample_images(state: GanState, z: torch.Tensor, labels: torch.Tensor,
                  ema: bool = False) -> torch.Tensor:
    """G's images in [-1, 1] for (z, labels) with its running averages
    (eval mode) and no gradient; with ``ema`` (and an EMA kept), with the
    EMA weights and EMA running averages."""
    g = state.generator
    if ema and state.g_ema is not None:
        g = copy.deepcopy(g)
        g.load_state_dict({**state.g_ema, **state.g_ema_stats})
    return eval_sampler(g)(z, labels)
