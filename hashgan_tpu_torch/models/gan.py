"""The PC-WGAN generator and critic (port of ``hashgan_tpu/models/gan.py``).

ResNet G and D in the improved-wgan-training style. G: a label embedding
concatenated to z, a dense layer to a 4x4 map, conditional-batch-norm
residual up-blocks (nearest-neighbour upsample + 3x3 convolution), batch
norm, ReLU, a 3x3 convolution and tanh. D: an "optimized" input block,
residual blocks (mean-pool downsample, optional LayerNorm), ReLU, a global
mean-pool, a scalar critic score and an auxiliary label head, with optional
projection conditioning ``+ <V y, phi(x)>``. D has no batch norm, so each
sample's score depends on that sample alone, which the gradient penalty
needs.

The public API is NHWC, as the reference's; the modules permute to NCHW
inside. Parameters are float32 and each op runs in ``dtype`` with its
weights cast to it (Flax's ``dtype`` / ``param_dtype``), except where the
reference runs float32: the label embedding, the normalisation statistics
(``models/layers.py``), G's tanh, and D's pooled features, critic, aux and
projection heads. Parameters carry over from Flax with
``models/convert.py::gan_flax_to_torch``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from hashgan_tpu_torch.models.encoders import conv, init_like_flax
from hashgan_tpu_torch.models.layers import (
    BatchNorm,
    CondBatchNorm,
    batch_norm_shards,
    cond_batch_norm_shards,
    layer_norm_channels,
)
from hashgan_tpu_torch.utils.profiling import count


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NCHW ``x``."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(
        n, c, 2 * h, 2 * w)


# D's ReLU and mean-pool are differentiated twice (the gradient penalty's
# double backward). PyTorch's second-order formulas for ``F.relu`` and
# ``F.avg_pool2d`` add ``zeros_like`` terms for the forward input, and the
# engine then runs a whole backward of D's forward graph on those zeros.
# These first-order versions run the same kernels, forward and backward,
# but build their backward as a node with no edge back into the forward
# graph, and pass an undefined gradient on as undefined, so the double
# backward stops there. Every gradient is the same, bit for bit: each
# dropped term is an exact ``+ 0``.


class _ReLUGrad(torch.autograd.Function):
    """(g, relu's output, detached) -> ReLU's input gradient; linear in g."""

    @staticmethod
    def forward(ctx, g, out):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(out)
        return torch.ops.aten.threshold_backward(g, out, 0)

    @staticmethod
    def backward(ctx, gg):
        if gg is None:
            return None, None
        return torch.ops.aten.threshold_backward(
            gg, ctx.saved_tensors[0], 0), None


class _ReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.set_materialize_grads(False)
        out = torch.relu(x)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None
        if torch.is_grad_enabled():  # a backward with create_graph
            count("gan.critic.first_order")
        return _ReLUGrad.apply(g, ctx.saved_tensors[0].detach())


class _MeanPoolGrad(torch.autograd.Function):
    """(g, the pool's input, detached: its geometry alone is read) -> the
    pool's input gradient; linear in g."""

    @staticmethod
    def forward(ctx, g, x):
        ctx.set_materialize_grads(False)
        return torch.ops.aten.avg_pool2d_backward(
            g, x, [2, 2], [2, 2], [0, 0], False, True, None)

    @staticmethod
    def backward(ctx, gg):
        if gg is None:
            return None, None
        return F.avg_pool2d(gg, 2), None


class _MeanPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x)
        return F.avg_pool2d(x, 2)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None
        if torch.is_grad_enabled():
            count("gan.critic.first_order")
        return _MeanPoolGrad.apply(g, ctx.saved_tensors[0].detach())


def critic_relu(x: torch.Tensor) -> torch.Tensor:
    """``F.relu`` whose backward has no edge back into the forward graph
    (the critic's; G, differentiated once, keeps ``F.relu``)."""
    return _ReLU.apply(x)


def meanpool2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean-pool of NCHW ``x`` (float32 sums, rounded to x's dtype, as
    the reference's mean of a low-precision array), ``F.avg_pool2d``'s, with
    a backward that has no edge back into the forward graph."""
    return _MeanPool.apply(x)


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class GenResBlock(nn.Module):
    """Conditional-batch-norm residual block with a 2x upsample."""

    def __init__(self, in_features: int, features: int, n_labels: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.bn1 = CondBatchNorm(n_labels, in_features)
        self.conv1 = nn.Conv2d(in_features, features, 3, padding=1)
        self.bn2 = CondBatchNorm(n_labels, features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.skip = (nn.Conv2d(in_features, features, 1)
                     if in_features != features else None)

    def forward(self, x: torch.Tensor, labels: torch.Tensor, train: bool,
                update: bool) -> torch.Tensor:
        return res_block_shards([self], [x], [labels], train, update)[0]

    def skip_path(self, x: torch.Tensor) -> torch.Tensor:
        skip = upsample2x(x)
        return skip if self.skip is None else conv(skip, self.skip,
                                                   self.dtype)


def res_block_shards(blocks: Sequence[GenResBlock],
                     xs: Sequence[torch.Tensor],
                     labels: Sequence[torch.Tensor], train: bool,
                     update: bool) -> List[torch.Tensor]:
    """``GenResBlock`` in lock-step over per-position shards: ``blocks``
    are one block's replicas, one a mesh position; each batch norm takes
    the global batch's statistics (``cond_batch_norm_shards``)."""
    dt = blocks[0].dtype
    hs = cond_batch_norm_shards([b.bn1 for b in blocks], xs, labels, train,
                                update)
    hs = [conv(upsample2x(F.relu(h)), b.conv1, dt)
          for b, h in zip(blocks, hs)]
    hs = cond_batch_norm_shards([b.bn2 for b in blocks], hs, labels, train,
                                update)
    return [conv(F.relu(h), b.conv2, dt) + b.skip_path(x)
            for b, h, x in zip(blocks, hs, xs)]


class Generator(nn.Module):
    """(z (N, z_dim), labels (N, K)) -> (N, H, W, C) float32 images in
    [-1, 1].

    ``forward(z, labels, train=True, update=True)``: ``train`` normalises by
    batch statistics (else the running averages); ``update`` writes them
    into the batch norms' buffers, as Flax's ``mutable=["batch_stats"]``."""

    def __init__(self, image_size: int = 32, n_labels: int = 10,
                 dim: int = 128, out_channels: int = 3,
                 label_embed_dim: int = 32,
                 dtype: torch.dtype = torch.float32,
                 width_mults: Optional[Sequence[int]] = None,
                 cond_label_norm: bool = False, z_dim: int = 128,
                 device: torch.device | str = "cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n_up = int(math.log2(image_size // 4))
        mults = tuple(width_mults or (1,) * (n_up + 1))
        if len(mults) != n_up + 1:
            raise ValueError(f"width_mults needs {n_up + 1} entries at "
                             f"{image_size}px, got {len(mults)}")
        self.dtype, self.cond_label_norm = dtype, cond_label_norm
        self.width0 = dim * mults[0]
        self.label_embed = (nn.Linear(n_labels, label_embed_dim)
                            if label_embed_dim else None)
        self.input = nn.Linear(z_dim + label_embed_dim, 16 * self.width0)
        self.blocks = nn.ModuleList(
            GenResBlock(dim * mults[i], dim * mults[i + 1], n_labels, dtype)
            for i in range(n_up))
        self.out_bn = BatchNorm(dim * mults[-1], dtype=dtype)
        self.out_conv = nn.Conv2d(dim * mults[-1], out_channels, 3, padding=1)
        init_like_flax(self, generator)
        self.to(device)

    def forward(self, z: torch.Tensor, labels: torch.Tensor,
                train: bool = True, update: bool = True) -> torch.Tensor:
        return generator_shards([self], [z], [labels], train, update)[0]

    def labels_in(self, labels: torch.Tensor) -> torch.Tensor:
        labels = labels.float()
        if self.cond_label_norm:
            labels = labels / labels.sum(dim=-1, keepdim=True).clamp_min(1.0)
        return labels

    def stem(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """z and the label embedding -> the dense layer's (N, C, 4, 4)
        map."""
        z = z.float()
        if self.label_embed is not None:
            z = torch.cat([z, self.label_embed(labels)], dim=-1)
        # the dense output is read as (4, 4, C), channels last, as Flax's
        # reshape reads it; only then to NCHW
        x = _dense(z, self.input, self.dtype).view(-1, 4, 4, self.width0)
        return x.permute(0, 3, 1, 2)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The output batch norm's result -> (N, H, W, C) images."""
        x = conv(F.relu(h), self.out_conv, self.dtype)
        return torch.tanh(x.float()).permute(0, 2, 3, 1)


def generator_shards(gens: Sequence[Generator], zs: Sequence[torch.Tensor],
                     labels: Sequence[torch.Tensor], train: bool = True,
                     update: bool = True) -> List[torch.Tensor]:
    """G in lock-step over per-position shards of one global batch:
    ``gens`` are G's replicas, one a mesh position (``gens[0]`` the master),
    ``zs`` and ``labels`` each position's rows. Layer by layer every shard
    runs on its replica; at each batch norm the shards' statistics are
    reduced to the global batch's (``models/layers.py::batch_norm_shards``),
    and with ``update`` the master's running averages move once. One shard
    is ``Generator.forward``. Returns each position's images."""
    labels = [g.labels_in(y) for g, y in zip(gens, labels)]
    xs = [g.stem(z, y) for g, z, y in zip(gens, zs, labels)]
    for i in range(len(gens[0].blocks)):
        xs = res_block_shards([g.blocks[i] for g in gens], xs, labels, train,
                              update)
    hs = batch_norm_shards([g.out_bn for g in gens], xs, train, update)
    return [g.head(h) for g, h in zip(gens, hs)]


class DiscResBlock(nn.Module):
    """Critic residual block: optional mean-pool downsample, optional
    LayerNorm (over channels, as Flax's on NHWC); ``first`` is the
    "optimized" input block (convolutions before any activation)."""

    def __init__(self, in_features: int, features: int, down: bool = False,
                 use_layernorm: bool = False, first: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.down, self.first, self.dtype = down, first, dtype
        norm = use_layernorm and not first
        self.ln1 = nn.LayerNorm(in_features, eps=1e-6) if norm else None
        self.conv1 = nn.Conv2d(in_features, features, 3, padding=1)
        self.ln2 = nn.LayerNorm(features, eps=1e-6) if norm else None
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.skip = (nn.Conv2d(in_features, features, 1)
                     if first or in_features != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.first:
            h = conv(critic_relu(conv(x, self.conv1, dt)), self.conv2, dt)
            return meanpool2x(h) + conv(meanpool2x(x), self.skip, dt)
        h = x if self.ln1 is None else layer_norm_channels(x, self.ln1, dt)
        h = conv(critic_relu(h), self.conv1, dt)
        if self.ln2 is not None:
            h = layer_norm_channels(h, self.ln2, dt)
        h = conv(critic_relu(h), self.conv2, dt)
        skip = x
        if self.down:
            h, skip = meanpool2x(h), meanpool2x(skip)
        if self.skip is not None:
            skip = conv(skip, self.skip, dt)
        return h + skip


class Discriminator(nn.Module):
    """(N, H, W, C) images [, labels] -> (critic score (N,), aux logits
    (N, K)), both float32. Without labels a projection critic scores the
    unconditional part alone (the sample-quality probe and
    ``wasserstein_noproj``)."""

    def __init__(self, image_size: int = 32, n_labels: int = 10,
                 dim: int = 128, in_channels: int = 3,
                 use_layernorm: bool = False,
                 dtype: torch.dtype = torch.float32,
                 width_mults: Optional[Sequence[int]] = None,
                 projection: bool = False,
                 device: torch.device | str = "cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n_extra = int(math.log2(image_size // 32))  # 0 at 32 px, 1 at 64
        n_blocks = 4 + n_extra
        m = tuple(width_mults or (1,) * n_blocks)
        if len(m) != n_blocks:
            raise ValueError(f"width_mults needs {n_blocks} entries at "
                             f"{image_size}px, got {len(m)}")
        self.dtype, self.projection = dtype, projection
        widths = [dim * k for k in m]
        ln = use_layernorm
        self.block_in = DiscResBlock(in_channels, widths[0], first=True,
                                     dtype=dtype)
        self.block_extra = nn.ModuleList(
            DiscResBlock(widths[i], widths[i + 1], down=True,
                         use_layernorm=ln, dtype=dtype)
            for i in range(n_extra))
        self.block_down = DiscResBlock(widths[n_extra], widths[n_extra + 1],
                                       down=True, use_layernorm=ln,
                                       dtype=dtype)
        self.block_a = DiscResBlock(widths[n_extra + 1], widths[n_extra + 2],
                                    use_layernorm=ln, dtype=dtype)
        self.block_b = DiscResBlock(widths[n_extra + 2], widths[n_extra + 3],
                                    use_layernorm=ln, dtype=dtype)
        self.critic = nn.Linear(widths[-1], 1)
        self.aux = nn.Linear(widths[-1], n_labels)
        self.proj_embed = (nn.Linear(n_labels, widths[-1], bias=False)
                           if projection else None)
        init_like_flax(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.dtype
        h = self.block_in(x.to(dt).permute(0, 3, 1, 2))
        for block in self.block_extra:
            h = block(h)
        h = self.block_b(self.block_a(self.block_down(h)))
        # the reference's mean of the compute dtype: float32 sums, rounded
        h = critic_relu(h).float().mean(dim=(2, 3)).to(dt).float()
        score = self.critic(h)[:, 0]
        aux = self.aux(h)
        if self.proj_embed is not None and labels is not None:
            score = score + (self.proj_embed(labels.float()) * h).sum(dim=-1)
        return score, aux


def build_gan(cfg, device: torch.device | str = "cpu",
              seed: Optional[int] = None) -> Tuple[Generator, Discriminator]:
    """G and D of ``cfg`` (``cfg.gan`` and the image geometry of
    ``cfg.data``), initialised on the CPU from ``seed`` (default
    ``cfg.train.seed``) and moved to ``device``."""
    from hashgan_tpu_torch.models.encoders import dtype_from_name

    g, d, k = cfg.gan, cfg.data, cfg.data.n_classes
    gen = torch.Generator().manual_seed(
        cfg.train.seed if seed is None else seed)
    dtype = dtype_from_name(g.compute_dtype)
    return (
        Generator(image_size=d.image_size, n_labels=k, dim=g.dim,
                  out_channels=d.channels, dtype=dtype,
                  width_mults=g.g_width_mults,
                  cond_label_norm=g.cond_label_norm, z_dim=g.z_dim,
                  device=device, generator=gen),
        Discriminator(image_size=d.image_size, n_labels=k, dim=g.dim,
                      in_channels=d.channels, use_layernorm=g.d_layernorm,
                      dtype=dtype, width_mults=g.d_width_mults,
                      projection=g.d_projection, device=device,
                      generator=gen),
    )
