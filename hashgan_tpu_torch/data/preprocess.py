"""Input preprocessing and augmentation (port of
``hashgan_tpu/data/preprocess.py``): the GAN's [-1, 1] range, the encoder's
mean-subtracted input, flips, crops, and the AlexNet input geometry (resize
to ``resize_base``, then a random crop in training or the central crop in
evaluation, to ``input_resize``).

Images stay uint8 until they are on the device; normalisation happens there.
The geometry runs on float32 NHWC tensors on their own device, one batch at
a time. The augmentations draw their random numbers on the CPU from a
``torch.Generator`` that ``step_generator`` seeds from ``(seed, step)``, so a
training step stays a pure function of its inputs and a resumed run draws
the same flips and crops. They do not draw the reference's bits
(``jax.random``); the parity tests feed both sides the same flip mask and
crop offsets. Both crops draw one offset an example and use it for the row
and the column, as the reference does (it draws both from one key, so its
crops lie on the diagonal).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

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


def _offsets(generator: torch.Generator, b: int, high: int,
             offsets: Optional[torch.Tensor], device: torch.device
             ) -> torch.Tensor:
    """(b,) crop offsets in [0, high): the given ones, else drawn."""
    if offsets is None:
        offsets = torch.randint(0, high, (b,), generator=generator)
    return _on(offsets, device)


def random_crop(generator: torch.Generator, images: torch.Tensor,
                pad: int = 4, offsets: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Pad-and-random-crop augmentation (edge padding, as the reference),
    at one offset in [0, 2 * pad] an example for both axes, drawn or given
    as a (B,) integer tensor."""
    r = _offsets(generator, images.shape[0], 2 * pad + 1, offsets,
                 images.device)
    return crop_images(images, r, r, pad)


def resize_images(images: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) images to (size, size), antialiased
    where it shrinks, as ``jax.image.resize(..., "bilinear")``; a no-op at
    that size already. It computes in float64: torch's float32 kernels
    are off by up to 4.5e-3 at 256 -> 227 on pixels in [-128, 128]
    (measured on the CPU), the float64 result rounded is within 2.3e-5 of
    the reference's."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    out = F.interpolate(images.permute(0, 3, 1, 2).double(),
                        size=(size, size), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.to(images.dtype).permute(0, 2, 3, 1)


def center_crop(images: torch.Tensor, size: int) -> torch.Tensor:
    """The central (size, size) window (the reference's evaluation crop)."""
    h, w = images.shape[1:3]
    y, x = (h - size) // 2, (w - size) // 2
    return images[:, y:y + size, x:x + size, :]


def random_crop_to(generator: torch.Generator, images: torch.Tensor,
                   size: int, offsets: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """A (size, size) window of each image at offset (r, r), r in
    [0, H - size] drawn or given as a (B,) integer tensor (the reference's
    training crop out of the resize)."""
    b, h, w, _ = images.shape
    if h == size and w == size:
        return images
    r = _offsets(generator, b, h - size + 1, offsets, images.device)
    span = torch.arange(size, device=images.device)
    idx = r.view(b, 1) + span
    bi = torch.arange(b, device=images.device).view(b, 1, 1)
    return images[bi, idx.view(b, size, 1), idx.view(b, 1, size)]


def alexnet_train_geometry(generator: torch.Generator, images: torch.Tensor,
                           input_resize: int, resize_base: int = 0,
                           offsets: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The reference's training protocol: resize to ``resize_base``, then a
    random crop to ``input_resize`` (a plain resize where ``resize_base``
    <= ``input_resize``)."""
    base = max(resize_base, input_resize)
    return random_crop_to(generator, resize_images(images, base),
                          input_resize, offsets)


def alexnet_eval_geometry(images: torch.Tensor, input_resize: int,
                          resize_base: int = 0) -> torch.Tensor:
    """The reference's evaluation protocol: resize to ``resize_base``, then
    the central crop to ``input_resize``."""
    base = max(resize_base, input_resize)
    return center_crop(resize_images(images, base), input_resize)
