"""The encoder's (stage-II) training step and the encode function (port of
``hashgan_tpu/train/hash_step.py``).

A step is augment -> forward -> WML loss -> backward -> Adam update, all on
the encoder's device; the uint8 batch is the only host->device traffic
besides the flip (and crop) draws. The step's random draws come from
``data/preprocess.py::step_generator(seed, step)``, which every encoder's
forward also receives (AlexNet seeds its dropout masks from it), so a step
is a pure function of its inputs and a resumed run repeats it exactly.
Given a generator, a step also trains on generated images (the reference's
``hash_step.py:66-89``): ``max(1, int(B * fake_ratio))`` fakes conditioned
on the first labels of the batch, which they inherit. With
``cfg.encoder.input_resize > 0`` the step applies the AlexNet training
geometry to the real and generated images together, and the encode
function the evaluation geometry, for any arch, as the reference does
(``hash_step.py:91-98, 135-141``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hashgan_tpu_torch.data.preprocess import (
    _on,
    alexnet_eval_geometry,
    alexnet_train_geometry,
    gan_to_encoder_input,
    random_crop,
    random_flip,
    step_generator,
    to_encoder_input,
)
from hashgan_tpu_torch.losses.pairwise import wml_pairwise_loss
from hashgan_tpu_torch.train.state import EncoderState


def encoder_loss_and_grad(encoder: nn.Module, x: torch.Tensor,
                          labels: torch.Tensor, cfg,
                          generator: Optional[torch.Generator] = None,
                          sample_weight: Optional[torch.Tensor] = None,
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward the already-augmented encoder inputs ``x`` (mean-subtracted
    float32, NHWC) in train mode, take the WML loss of ``cfg.hash_loss``
    against ``labels`` (pairs weighted by ``sample_weight``, when given),
    and backpropagate: the gradients are left in the parameters' ``.grad``
    (set anew, not accumulated). ``generator`` is the step's, for an
    encoder that draws (AlexNet's dropout). Returns (loss, metrics)."""
    hl = cfg.hash_loss
    encoder.train()
    encoder.zero_grad(set_to_none=True)
    codes = encoder(x, generator=generator)
    loss, metrics = wml_pairwise_loss(
        codes, labels, alpha=hl.alpha, similarity=hl.similarity,
        class_balance=hl.class_balance,
        class_balance_cap=hl.class_balance_cap,
        class_balance_mode=hl.class_balance_mode,
        quantization_weight=hl.quantization_weight,
        balance_weight=hl.balance_weight, sample_weight=sample_weight)
    loss.backward()
    return loss, metrics


def add_fakes(x: torch.Tensor, labels: torch.Tensor, cfg,
              sample: Callable, z: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Real encoder inputs ``x`` (B, ...) and their labels, extended by
    ``len(z)`` generated images conditioned on ``labels[:len(z)]`` (which
    they inherit); ``sample(z, labels)`` gives G's [-1, 1] images without a
    gradient. Returns (inputs, labels, per-sample pair weights or None):
    the weights, 1 for real and ``cfg.train.fake_pair_weight`` for
    generated images, only where that weight is not 1."""
    n, n_fake = x.shape[0], z.shape[0]
    fake_labels = labels[:n_fake]
    fake = gan_to_encoder_input(sample(z, fake_labels))
    weights = None
    w = cfg.train.fake_pair_weight
    if w != 1.0:
        weights = torch.cat([
            torch.ones(n, dtype=torch.float32, device=x.device),
            torch.full((n_fake,), w, dtype=torch.float32, device=x.device)])
    return (torch.cat([x, fake]), torch.cat([labels, fake_labels]), weights)


def make_encoder_train_step(cfg) -> Callable:
    """``step(state, images_u8, labels, sample=None, flip=None, z=None,
    crop=None, geometry=None) -> metrics``: updates ``state`` (an
    ``EncoderState``) in place, advances ``state.step``, and returns the
    loss metrics as 0-dim tensors on the device (reading them synchronises;
    the loop does so at log points only). ``images_u8`` (B, H, W, C) uint8
    and ``labels`` (B, K) float32 are tensors on the encoder's device. With
    ``sample`` (G's sampler, see ``add_fakes``) the batch is extended by
    ``max(1, int(B * fake_ratio))`` generated images, after the flip (and
    crop) of the real ones; the AlexNet geometry (``input_resize > 0``)
    then applies to all of them. ``flip`` (B,) bool, ``crop`` (B,) and
    ``geometry`` (B + n_fake,) integer offsets and ``z`` (n_fake, z_dim)
    replace the step's own draws (the parity tests feed the reference's)."""
    crop_pad = cfg.train.crop_pad
    input_resize = cfg.encoder.input_resize
    resize_base = cfg.encoder.resize_base
    seed = cfg.train.seed

    def step(state: EncoderState, images_u8: torch.Tensor,
             labels: torch.Tensor, sample: Optional[Callable] = None,
             flip: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None,
             crop: Optional[torch.Tensor] = None,
             geometry: Optional[torch.Tensor] = None,
             ) -> Dict[str, torch.Tensor]:
        gen = step_generator(seed, state.step)
        x = random_flip(gen, to_encoder_input(images_u8), flip)
        if crop_pad > 0:
            x = random_crop(gen, x, pad=crop_pad, offsets=crop)
        weights = None
        if sample is not None:
            if z is None:
                n_fake = max(1, int(x.shape[0] * cfg.train.fake_ratio))
                z = torch.randn(n_fake, cfg.gan.z_dim, generator=gen)
            x, labels, weights = add_fakes(x, labels, cfg, sample,
                                           _on(z, x.device))
        if input_resize > 0:
            x = alexnet_train_geometry(gen, x, input_resize, resize_base,
                                       offsets=geometry)
        _, metrics = encoder_loss_and_grad(state.module, x, labels, cfg,
                                           generator=gen,
                                           sample_weight=weights)
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
    in the module. With ``cfg.encoder.input_resize > 0`` the images pass
    the AlexNet evaluation geometry (resize to ``resize_base``, the central
    crop) in float32 before the forward."""
    input_resize = cfg.encoder.input_resize if cfg is not None else 0
    resize_base = cfg.encoder.resize_base if cfg is not None else 0
    device = next(encoder.parameters()).device

    def encode(images_u8) -> torch.Tensor:
        x = torch.as_tensor(images_u8)
        if x.dtype != torch.uint8:
            raise ValueError(f"images must be uint8, got {x.dtype}")
        was_training = encoder.training
        encoder.eval()
        try:
            with torch.inference_mode():
                x = to_encoder_input(x.to(device))
                if input_resize > 0:
                    x = alexnet_eval_geometry(x, input_resize, resize_base)
                return encoder(x)
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
