"""Training states and optimisers of the encoder and the GAN (port of
``hashgan_tpu/train/state.py``).

The reference's encoder optimiser is ``optax.adam(lr)`` (beta1 0.9, beta2
0.999, eps 1e-8), chained with a 10x ``optax.scale`` on the ``hash`` subtree
that applies *after* Adam. Adam's update is lr * m_hat / (sqrt(v_hat) + eps)
with eps inside, so scaling it by 10 is exactly a parameter group at 10x
lr: the port uses two groups of ``torch.optim.Adam``. ``decay_lr`` is
``optax.linear_schedule(lr, 0, iters)``, which counts updates from 0, so a
``LambdaLR`` with factor ``1 - c / iters`` gives the first update the full
lr.

The GAN's optimisers are ``optax.adam(lr, b1=0, b2=0.9)`` (eps 1e-8) with
``linear_schedule(lr, 0, iters * updates_per_iter)``: G takes one update a
cycle and D ``n_critic``, so D's horizon is stretched by ``n_critic``
(``make_gan_tx``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hashgan_tpu_torch.models.alexnet import load_bvlc_weights
from hashgan_tpu_torch.models.encoders import build_encoder, dtype_from_name
from hashgan_tpu_torch.models.gan import Discriminator, Generator, build_gan

HASH_PREFIX = "hash."  # the re-initialised hash layer (the reference's "hash")


@dataclasses.dataclass
class EncoderState:
    """The module (parameters), its optimiser and lr schedule, and the
    number of steps taken."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR]
    step: int = 0


def parameter_groups(module: nn.Module, cfg) -> List[dict]:
    """The backbone at ``cfg.lr`` and the hash layer at
    ``cfg.lr * cfg.hash_lr_multiplier`` (one group when the multiplier
    is 1)."""
    named = list(module.named_parameters())
    base = [p for name, p in named if not name.startswith(HASH_PREFIX)]
    head = [p for name, p in named if name.startswith(HASH_PREFIX)]
    if cfg.hash_lr_multiplier == 1.0:
        return [{"params": base + head, "lr": cfg.lr}]
    return [{"params": base, "lr": cfg.lr},
            {"params": head, "lr": cfg.lr * cfg.hash_lr_multiplier}]


def _linear_decay(opt: torch.optim.Optimizer, horizon: int
                  ) -> torch.optim.lr_scheduler.LambdaLR:
    """``optax.linear_schedule(lr, 0, horizon)``: the factor 1 - c / horizon
    at update count c, from 1 at the first update down to 0."""

    def factor(count: int) -> float:
        return max(0.0, 1.0 - count / horizon) if horizon > 0 else 1.0

    return torch.optim.lr_scheduler.LambdaLR(opt, factor)


def make_encoder_tx(module: nn.Module, cfg, capturable: bool = False
                    ) -> Tuple[torch.optim.Adam,
                               Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """(Adam, linear-decay schedule or None) for ``module`` under an
    ``EncoderConfig``. Call ``scheduler.step()`` after each
    ``optimizer.step()``. With ``capturable`` (a CUDA graph replays the
    update: ``train/graph_step.py``) Adam keeps its step counts on the
    device and each group's lr is a float32 tensor there, which the
    schedule fills with the value it computes in float64 on the host."""
    opt = torch.optim.Adam(parameter_groups(module, cfg), lr=cfg.lr,
                           betas=(0.9, 0.999), eps=1e-8,
                           capturable=capturable)
    sched = _linear_decay(opt, cfg.iters) if cfg.decay_lr else None
    if capturable:
        _tensor_lrs(opt, module)
    return opt, sched


def _tensor_lrs(opt: torch.optim.Optimizer, module: nn.Module) -> None:
    """Each group's lr as a float32 tensor on ``module``'s device (made
    after the schedule, which reads the float lrs as its base)."""
    device = next(module.parameters()).device
    for g in opt.param_groups:
        g["lr"] = torch.tensor(g["lr"], dtype=torch.float32, device=device)


def make_gan_tx(module: nn.Module, cfg, updates_per_iter: int = 1,
                capturable: bool = False
                ) -> Tuple[torch.optim.Adam,
                           Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """(Adam with ``cfg.beta1`` / ``cfg.beta2``, linear decay over
    ``cfg.iters * updates_per_iter`` updates or None) for a G or D under a
    ``GanConfig``. ``capturable`` as in ``make_encoder_tx`` (a CUDA graph
    replays the cycle: ``train/graph_step.py::GraphedGanCycle``)."""
    opt = torch.optim.Adam(module.parameters(), lr=cfg.lr,
                           betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                           capturable=capturable)
    sched = (_linear_decay(opt, cfg.iters * updates_per_iter)
             if cfg.decay_lr else None)
    if capturable:
        _tensor_lrs(opt, module)
    return opt, sched


def create_encoder_state(cfg, device: torch.device | str,
                         capturable: bool = False) -> EncoderState:
    """The encoder of ``cfg`` with seeded initial weights (``cfg.train.seed``,
    drawn on the CPU so every device starts from the same weights) on
    ``device``, and a fresh optimiser (``capturable``: see
    ``make_encoder_tx``). With ``cfg.encoder.pretrained_npy`` the layers of
    a bvlc_alexnet.npy whose shapes match are loaded over the initial
    weights, whatever the arch, as in the reference
    (``train/state.py:94-98``)."""
    module = build_encoder(
        cfg.encoder.arch, cfg.encoder.bits,
        dtype=dtype_from_name(cfg.encoder.compute_dtype), device=device,
        generator=torch.Generator().manual_seed(cfg.train.seed),
        image_size=cfg.data.image_size, input_resize=cfg.encoder.input_resize)
    if cfg.encoder.pretrained_npy:
        module.load_state_dict(load_bvlc_weights(module.state_dict(),
                                                 cfg.encoder.pretrained_npy))
    opt, sched = make_encoder_tx(module, cfg.encoder, capturable)
    return EncoderState(module=module, optimizer=opt, scheduler=sched)


@dataclasses.dataclass
class GanState:
    """G (its batch-norm running averages are its buffers, the reference's
    ``g_stats``), D, their optimisers and schedules, the number of cycles
    taken, and, when ``ema_decay > 0``, the EMA of G's parameters
    (``g_ema``, by parameter name) and of its running averages
    (``g_ema_stats``, by buffer name)."""

    generator: Generator
    discriminator: Discriminator
    g_opt: torch.optim.Optimizer
    g_sched: Optional[torch.optim.lr_scheduler.LambdaLR]
    d_opt: torch.optim.Optimizer
    d_sched: Optional[torch.optim.lr_scheduler.LambdaLR]
    step: int = 0
    g_ema: Optional[Dict[str, torch.Tensor]] = None
    g_ema_stats: Optional[Dict[str, torch.Tensor]] = None


_GAN_INIT_TAG = 0x6A17  # G and D draw their init apart from the encoder


def create_gan_state(cfg, device: torch.device | str,
                     capturable: bool = False) -> GanState:
    """G and D of ``cfg`` with seeded initial weights (drawn on the CPU
    from (``cfg.train.seed``, a tag of their own)) on ``device``, fresh
    optimisers (``capturable``: see ``make_gan_tx``), and distinct EMA
    copies when ``cfg.gan.ema_decay > 0``."""
    seed = int(np.random.SeedSequence([cfg.train.seed, _GAN_INIT_TAG])
               .generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)
    g, d = build_gan(cfg, device=device, seed=seed)
    g_opt, g_sched = make_gan_tx(g, cfg.gan, capturable=capturable)
    d_opt, d_sched = make_gan_tx(d, cfg.gan, updates_per_iter=cfg.gan.n_critic,
                                 capturable=capturable)
    ema = ema_stats = None
    if cfg.gan.ema_decay > 0:
        ema = {k: p.detach().clone() for k, p in g.named_parameters()}
        ema_stats = {k: b.clone() for k, b in g.named_buffers()}
    return GanState(g, d, g_opt, g_sched, d_opt, d_sched, g_ema=ema,
                    g_ema_stats=ema_stats)
