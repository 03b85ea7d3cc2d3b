"""The encoder's (stage-II) training step and the encode function (port of
``hashgan_tpu/train/hash_step.py``).

A step is augment -> forward -> WML loss -> backward -> Adam update, all on
the encoder's device; the uint8 batch is the only host->device traffic
besides the flip (and crop) draws. The step's random draws come from
``data/preprocess.py::step_generator(seed, step)``, so a step is a pure
function of its inputs and a resumed run repeats it exactly. Training
against GAN samples (stage II with ``use_gan``) and the AlexNet input
geometry are not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hashgan_tpu_torch.data.preprocess import (
    random_crop,
    random_flip,
    step_generator,
    to_encoder_input,
)
from hashgan_tpu_torch.losses.pairwise import wml_pairwise_loss
from hashgan_tpu_torch.train.state import EncoderState


def _check_ported(cfg) -> None:
    if cfg.use_gan:
        raise NotImplementedError(
            "stage-II training on GAN samples (use_gan=True) is not ported "
            "yet (ROADMAP.md, GAN stage I)")
    if cfg.encoder.input_resize > 0:
        raise NotImplementedError(
            "input_resize > 0 (the AlexNet train geometry) is not ported yet "
            "(ROADMAP.md)")


def encoder_loss_and_grad(encoder: nn.Module, x: torch.Tensor,
                          labels: torch.Tensor, cfg,
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward the already-augmented encoder inputs ``x`` (mean-subtracted
    float32, NHWC) in train mode, take the WML loss of ``cfg.hash_loss``
    against ``labels``, and backpropagate: the gradients are left in the
    parameters' ``.grad`` (set anew, not accumulated). Returns (loss,
    metrics)."""
    hl = cfg.hash_loss
    encoder.train()
    encoder.zero_grad(set_to_none=True)
    codes = encoder(x)
    loss, metrics = wml_pairwise_loss(
        codes, labels, alpha=hl.alpha, similarity=hl.similarity,
        class_balance=hl.class_balance,
        class_balance_cap=hl.class_balance_cap,
        class_balance_mode=hl.class_balance_mode,
        quantization_weight=hl.quantization_weight,
        balance_weight=hl.balance_weight)
    loss.backward()
    return loss, metrics


def make_encoder_train_step(cfg) -> Callable:
    """``step(state, images_u8, labels) -> metrics`` for ``use_gan=False``:
    updates ``state`` (an ``EncoderState``) in place, advances
    ``state.step``, and returns the loss metrics as 0-dim tensors on the
    device (reading them synchronises; the loop does so at log points
    only). ``images_u8`` (B, H, W, C) uint8 and ``labels`` (B, K) float32
    are tensors on the encoder's device."""
    _check_ported(cfg)
    crop_pad = cfg.train.crop_pad
    seed = cfg.train.seed

    def step(state: EncoderState, images_u8: torch.Tensor,
             labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        gen = step_generator(seed, state.step)
        x = random_flip(gen, to_encoder_input(images_u8))
        if crop_pad > 0:
            x = random_crop(gen, x, pad=crop_pad)
        _, metrics = encoder_loss_and_grad(state.module, x, labels, cfg)
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_encode_fn(encoder: nn.Module, cfg=None) -> Callable:
    """``encode(images_u8) -> (B, bits) float32 codes`` in eval mode on the
    encoder's device; the module's previous mode is restored afterwards.
    ``images_u8`` is an (B, H, W, 3) uint8 tensor or numpy array. The
    reference's ``make_encode_fn`` takes ``params`` as well; here they live
    in the module.

    Only ``cfg.encoder.input_resize == 0`` (native-size inputs) is ported;
    the AlexNet resize/crop protocol comes with the AlexNet encoder."""
    if cfg is not None and cfg.encoder.input_resize > 0:
        raise NotImplementedError(
            "input_resize > 0 (the AlexNet eval geometry) is not ported yet "
            "(ROADMAP.md)"
        )
    device = next(encoder.parameters()).device

    def encode(images_u8) -> torch.Tensor:
        x = torch.as_tensor(images_u8)
        if x.dtype != torch.uint8:
            raise ValueError(f"images must be uint8, got {x.dtype}")
        was_training = encoder.training
        encoder.eval()
        try:
            with torch.inference_mode():
                return encoder(to_encoder_input(x.to(device)))
        finally:
            encoder.train(was_training)

    return encode


def encode_dataset(encode_fn: Callable, dataset,
                   batch_size: int = 256) -> torch.Tensor:
    """Encode a split (anything with an ``images`` (N, H, W, 3) uint8 array)
    in order, batch by batch. Returns the (N, bits) codes on the encoder's
    device, where the gallery is built (the reference returns numpy)."""
    images = dataset.images
    out = [encode_fn(np.ascontiguousarray(images[lo:lo + batch_size]))
           for lo in range(0, len(images), batch_size)]
    return torch.cat(out, dim=0)
