"""Input preprocessing and augmentation (port of
``hashgan_tpu/data/preprocess.py:15-46, 102-112``): the GAN's [-1, 1] range,
the encoder's mean-subtracted input, flips and crops.

Images stay uint8 until they are on the device; normalisation happens there.
The augmentations draw their random numbers on the CPU from a
``torch.Generator`` that ``step_generator`` seeds from ``(seed, step)``, so a
training step stays a pure function of its inputs and a resumed run draws
the same flips and crops. They do not draw the reference's bits
(``jax.random``); the parity tests feed both sides one explicit flip mask
through ``flip_images``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

# BGR means of bvlc_alexnet's training set, applied in RGB order (as in the
# reference).
ALEXNET_MEAN_RGB = (122.7717, 115.9465, 102.9801)


@functools.lru_cache(maxsize=None)
def _mean_rgb(device: torch.device) -> torch.Tensor:
    # Made once per device: a host->device copy on every call would
    # synchronise the stream and serialise the serving pipeline.
    return torch.tensor(ALEXNET_MEAN_RGB, dtype=torch.float32, device=device)


def to_gan_range(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1] (G's tanh range)."""
    return images_u8.to(torch.float32) / 127.5 - 1.0


def from_gan_range(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 [0, 255] (truncated, as the reference's cast)."""
    return ((images + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


def to_encoder_input(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> mean-subtracted float32, NHWC like the reference."""
    return images_u8.to(torch.float32) - _mean_rgb(images_u8.device)


def gan_to_encoder_input(images_gan: torch.Tensor) -> torch.Tensor:
    """G's output in [-1, 1] -> the encoder's input (stage II trains on real
    and generated images in one batch)."""
    return (images_gan + 1.0) * 127.5 - _mean_rgb(images_gan.device)


_AUGMENT_TAG = 0xA067  # keeps these draws apart from the batch sampler's


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from (seed, step) through numpy's SeedSequence
    (the counterpart of the reference's ``fold_in(rng, step)``)."""
    state = np.random.SeedSequence(
        [seed, step, _AUGMENT_TAG]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & ((1 << 63) - 1))


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A small CPU tensor on ``device`` without stalling the host."""
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def flip_images(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of the (B, H, W, C) images where the (B,) bool
    ``flip`` is set."""
    return torch.where(flip.view(-1, 1, 1, 1), images.flip(2), images)


def random_flip(generator: torch.Generator, images: torch.Tensor,
                flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-example horizontal flip with probability 1/2, or by the given
    (B,) bool mask (the parity tests feed the reference's)."""
    if flip is None:
        flip = torch.rand(images.shape[0], generator=generator) < 0.5
    return flip_images(images, _on(flip, images.device))


def crop_images(images: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor,
                pad: int) -> torch.Tensor:
    """Pad each (H, W) image by ``pad`` with its edge values, then cut the
    window at offset (ry, rx) in [0, 2 * pad]: a gather with clamped
    indices, so no padded copy is made."""
    b, h, w, _ = images.shape
    dev = images.device
    rows = (ry.view(b, 1) - pad + torch.arange(h, device=dev)).clamp(0, h - 1)
    cols = (rx.view(b, 1) - pad + torch.arange(w, device=dev)).clamp(0, w - 1)
    bi = torch.arange(b, device=dev).view(b, 1, 1)
    return images[bi, rows.view(b, h, 1), cols.view(b, 1, w)]


def random_crop(generator: torch.Generator, images: torch.Tensor,
                pad: int = 4) -> torch.Tensor:
    """Pad-and-random-crop augmentation (edge padding, as the reference)."""
    b = images.shape[0]
    ry = torch.randint(0, 2 * pad + 1, (b,), generator=generator)
    rx = torch.randint(0, 2 * pad + 1, (b,), generator=generator)
    return crop_images(images, _on(ry, images.device),
                       _on(rx, images.device), pad)
