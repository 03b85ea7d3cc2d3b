"""Encoder input preprocessing (port of ``hashgan_tpu/data/preprocess.py:15-33``).

Images stay uint8 until they are on the device; normalisation happens there.
"""

from __future__ import annotations

import functools

import torch

# BGR means of bvlc_alexnet's training set, applied in RGB order (as in the
# reference).
ALEXNET_MEAN_RGB = (122.7717, 115.9465, 102.9801)


@functools.lru_cache(maxsize=None)
def _mean_rgb(device: torch.device) -> torch.Tensor:
    # Made once per device: a host->device copy on every call would
    # synchronise the stream and serialise the serving pipeline.
    return torch.tensor(ALEXNET_MEAN_RGB, dtype=torch.float32, device=device)


def to_encoder_input(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> mean-subtracted float32, NHWC like the reference."""
    return images_u8.to(torch.float32) - _mean_rgb(images_u8.device)
