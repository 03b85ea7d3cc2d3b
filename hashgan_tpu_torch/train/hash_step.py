"""Encoding (port of ``hashgan_tpu/train/hash_step.py:130-182``, encode only).

The encoder's training step belongs to the stage-II slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from hashgan_tpu_torch.data.preprocess import to_encoder_input


def make_encode_fn(encoder: nn.Module, cfg=None) -> Callable:
    """``encode(images_u8) -> (B, bits) float32 codes`` in eval mode on the
    encoder's device. ``images_u8`` is an (B, H, W, 3) uint8 tensor or numpy
    array. The reference's ``make_encode_fn`` takes ``params`` as well; here
    they live in the module.

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
        encoder.eval()
        with torch.inference_mode():
            return encoder(to_encoder_input(x.to(device)))

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
