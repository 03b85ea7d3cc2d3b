"""Shared layers of the port's encoders (port of
``hashgan_tpu/models/layers.py:60-79``; the GAN's conditional batch norm
comes with the GAN)."""

from __future__ import annotations

import torch


def local_response_norm(x: torch.Tensor, radius: int = 2, alpha: float = 2e-5,
                        beta: float = 0.75, bias: float = 1.0,
                        dim: int = -1) -> torch.Tensor:
    """AlexNet's cross-channel LRN over a window of ``2 * radius + 1``
    channels along ``dim`` (the last, as in the reference's NHWC; the AlexNet
    module passes its NCHW channel dim 1), in the input's dtype.

    ``alpha`` already includes the window-size normalisation (the TF
    convention the reference uses). ``F.local_response_norm`` divides its
    alpha by the window size, so it is not used here; the five shifted sums
    are written out in the reference's order."""
    c = x.shape[dim]
    squared = x * x
    pad_shape = list(x.shape)
    pad_shape[dim] = radius
    zeros = squared.new_zeros(pad_shape)
    padded = torch.cat([zeros, squared, zeros], dim=dim)
    acc = torch.zeros_like(x)
    for i in range(2 * radius + 1):
        acc = acc + padded.narrow(dim, i, c)
    return x / torch.pow(bias + alpha * acc, beta)
