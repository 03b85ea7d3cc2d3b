"""Shared layers (port of ``hashgan_tpu/models/layers.py``): AlexNet's
LRN, and the GAN's normalisations with Flax's numerics (the batch norm of
``flax.linen.BatchNorm``, the conditional batch norm, and Flax's
``LayerNorm`` over channels). ``batch_norm_shards`` and
``cond_batch_norm_shards`` run a batch norm over a global batch held as
per-position shards of a data-parallel mesh (``parallel/data_parallel.py``),
with the statistics of the whole batch, as the reference's batch norm takes
them under GSPMD."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn


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


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over (N, H, W) of an NCHW tensor.

    Flax's conventions, which torch's ``F.batch_norm`` does not share:

    - the running averages move as ``m * avg + (1 - m) * batch`` with
      ``momentum`` m = 0.9 (torch's ``momentum=0.1``), and the running
      variance takes the *biased* batch variance (torch's the unbiased);
    - statistics and normalisation are float32 whatever the input's dtype,
      cast to ``dtype`` (default: the input's) at the end. Flax takes the
      variance as E[x^2] - mean^2; torch's fused kernel and ``var_mean``
      take it directly, which differs by rounding only.

    ``forward(x, train, update)``: batch statistics when ``train`` (written
    into the ``mean`` / ``var`` buffers only when ``update``: the GAN's
    critic steps run G in train mode and discard them), the running ones
    otherwise."""

    def __init__(self, features: int, affine: bool = True,
                 momentum: float = 0.9, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(features)) if affine else None
        self.bias = nn.Parameter(torch.zeros(features)) if affine else None
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = True,
                update: bool = True) -> torch.Tensor:
        xf = x.float()
        if train and update:
            with torch.no_grad():
                var, mean = torch.var_mean(xf, dim=(0, 2, 3),
                                           correction=0)
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        # one fused normalisation; with ``train`` it takes the batch's own
        # biased statistics, as Flax does
        y = torch.nn.functional.batch_norm(
            xf, None if train else self.mean, None if train else self.var,
            self.weight, self.bias, training=train, eps=self.eps)
        return y.to(self.dtype or x.dtype)


def batch_norm_shards(norms: Sequence[BatchNorm], xs: Sequence[torch.Tensor],
                      train: bool = True, update: bool = True
                      ) -> List[torch.Tensor]:
    """``BatchNorm`` over the global batch held as shards ``xs`` (NCHW, one
    a mesh position, on the devices of ``norms``, the per-position replicas
    of one batch norm, ``norms[0]`` the master's). One shard is
    ``norms[0]``'s own forward. Otherwise, with ``train``, every shard's
    float32 per-channel sum and sum of squares are gathered on the first
    shard's device and added in position order, reduced to the global mean
    and E[x^2] - mean^2 (Flax's formula, clipped at 0), sent back, and each
    shard normalised with them and its replica's scale and bias, all inside
    the autograd graph, so the gradient couples the shards as the
    reference's does. The running averages move once, on the master, and
    only with ``update``. Without ``train`` each shard takes its replica's
    running averages."""
    if len(xs) == 1:
        return [norms[0](xs[0], train, update)]
    if not train:
        return [n(x, False) for n, x in zip(norms, xs)]
    xfs = [x.float() for x in xs]
    home = xfs[0].device
    s = ss = None
    for xf in xfs:
        part = xf.sum(dim=(0, 2, 3)).to(home, non_blocking=True)
        sq = xf.square().sum(dim=(0, 2, 3)).to(home, non_blocking=True)
        s, ss = (part, sq) if s is None else (s + part, ss + sq)
    count = sum(xf.numel() // xf.shape[1] for xf in xfs)
    mean = s / count
    var = (ss / count - mean.square()).clamp_min(0.0)
    master = norms[0]
    if update:
        with torch.no_grad():
            m = master.momentum
            master.mean.copy_(m * master.mean + (1.0 - m) * mean)
            master.var.copy_(m * master.var + (1.0 - m) * var)
    inv = torch.rsqrt(var + master.eps)
    out = []
    for n, x, xf in zip(norms, xs, xfs):
        d = xf.device
        y = ((xf - mean.to(d, non_blocking=True).view(1, -1, 1, 1))
             * inv.to(d, non_blocking=True).view(1, -1, 1, 1))
        if n.weight is not None:
            y = y * n.weight.view(1, -1, 1, 1) + n.bias.view(1, -1, 1, 1)
        out.append(y.to(master.dtype or x.dtype))
    return out


class CondBatchNorm(nn.Module):
    """Batch norm whose gain and bias are affine in the label vector (port
    of ``hashgan_tpu/models/layers.py:19-57``): ``gamma(y) = 1 + y @ G``,
    ``beta(y) = y @ B``, for one-hot y a per-class table. The tables are
    float32 and the products are cast to the activation's dtype, where the
    modulation runs; the statistics are ``BatchNorm``'s without scale or
    bias."""

    def __init__(self, n_labels: int, features: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(n_labels, features))
        self.beta = nn.Parameter(torch.zeros(n_labels, features))
        self.norm = BatchNorm(features, affine=False)

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool = True, update: bool = True) -> torch.Tensor:
        return self.modulate(self.norm(x, train, update), labels, x.dtype)

    def modulate(self, h: torch.Tensor, labels: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
        """The normalised ``h`` scaled and shifted by the labels' gain and
        bias, in ``dtype``."""
        labels = labels.float()
        gamma = (1.0 + labels @ self.gamma).to(dtype)[:, :, None, None]
        beta = (labels @ self.beta).to(dtype)[:, :, None, None]
        return h * gamma + beta


def cond_batch_norm_shards(norms: Sequence[CondBatchNorm],
                           xs: Sequence[torch.Tensor],
                           labels: Sequence[torch.Tensor], train: bool = True,
                           update: bool = True) -> List[torch.Tensor]:
    """``CondBatchNorm`` over the global batch held as shards (see
    ``batch_norm_shards``), each shard modulated by its own labels and its
    replica's tables."""
    hs = batch_norm_shards([n.norm for n in norms], xs, train, update)
    return [n.modulate(h, y, x.dtype)
            for n, h, y, x in zip(norms, hs, labels, xs)]


def layer_norm_channels(x: torch.Tensor, norm: nn.LayerNorm,
                        dtype: torch.dtype) -> torch.Tensor:
    """Flax's ``nn.LayerNorm`` on an NHWC tensor, applied to NCHW ``x``:
    each pixel normalised over its channels (dim 1, not (C, H, W)), with
    float32 statistics (E[x^2] - mean^2, clipped at 0), ``norm.eps`` and
    float32 scale and bias, cast to ``dtype``."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = ((xf * xf).mean(dim=1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + norm.eps) * norm.weight.view(1, -1, 1, 1)
    return ((xf - mean) * mul + norm.bias.view(1, -1, 1, 1)).to(dtype)
