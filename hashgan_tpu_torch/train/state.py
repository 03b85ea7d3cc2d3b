"""The encoder's training state and optimiser (port of
``hashgan_tpu/train/state.py:68-82, 160-163, 222-239``).

The reference's encoder optimiser is ``optax.adam(lr)`` (beta1 0.9, beta2
0.999, eps 1e-8), chained with a 10x ``optax.scale`` on the ``hash`` subtree
that applies *after* Adam. Adam's update is lr * m_hat / (sqrt(v_hat) + eps)
with eps inside, so scaling it by 10 is exactly a parameter group at 10x
lr: the port uses two groups of ``torch.optim.Adam``. ``decay_lr`` is
``optax.linear_schedule(lr, 0, iters)``, which counts updates from 0, so a
``LambdaLR`` with factor ``1 - c / iters`` gives the first update the full
lr. (Beta1 0 and beta2 0.9 are the GAN's, not the encoder's.)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from hashgan_tpu_torch.models.alexnet import load_bvlc_weights
from hashgan_tpu_torch.models.encoders import build_encoder, dtype_from_name

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


def make_encoder_tx(module: nn.Module, cfg
                    ) -> Tuple[torch.optim.Adam,
                               Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """(Adam, linear-decay schedule or None) for ``module`` under an
    ``EncoderConfig``. Call ``scheduler.step()`` after each
    ``optimizer.step()``."""
    opt = torch.optim.Adam(parameter_groups(module, cfg), lr=cfg.lr,
                           betas=(0.9, 0.999), eps=1e-8)
    if not cfg.decay_lr:
        return opt, None
    iters = cfg.iters

    def factor(count: int) -> float:
        return max(0.0, 1.0 - count / iters) if iters > 0 else 1.0

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def create_encoder_state(cfg, device: torch.device | str) -> EncoderState:
    """The encoder of ``cfg`` with seeded initial weights (``cfg.train.seed``,
    drawn on the CPU so every device starts from the same weights) on
    ``device``, and a fresh optimiser. With ``cfg.encoder.pretrained_npy``
    the layers of a bvlc_alexnet.npy whose shapes match are loaded over the
    initial weights, whatever the arch, as in the reference
    (``train/state.py:94-98``)."""
    module = build_encoder(
        cfg.encoder.arch, cfg.encoder.bits,
        dtype=dtype_from_name(cfg.encoder.compute_dtype), device=device,
        generator=torch.Generator().manual_seed(cfg.train.seed),
        image_size=cfg.data.image_size, input_resize=cfg.encoder.input_resize)
    if cfg.encoder.pretrained_npy:
        module.load_state_dict(load_bvlc_weights(module.state_dict(),
                                                 cfg.encoder.pretrained_npy))
    opt, sched = make_encoder_tx(module, cfg.encoder)
    return EncoderState(module=module, optimizer=opt, scheduler=sched)
