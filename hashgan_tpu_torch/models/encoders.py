"""Hash encoders F: image -> b continuous codes in (-1, 1).

Port of ``hashgan_tpu/models/encoders.py`` (SmallCNN, the ResNet-18-shaped
backbone, ``build_encoder``); AlexNet is ``models/alexnet.py``. The public
API takes NHWC inputs, as the reference does, and permutes to NCHW inside.
The layers match Flax's: convolutions with Flax's SAME padding (for a
stride-2 3x3 convolution on an even input that is (0, 1), not torch's
symmetric (1, 1)), GroupNorm and LayerNorm with Flax's epsilon of 1e-6
(torch's default is 1e-5), 2x2 VALID average pooling. Parameters carry over
from a Flax tree with ``models/convert.py::flax_to_torch``.

``dtype`` is the compute dtype of the backbone (the presets use bfloat16,
``configs/config.py:108``). Every parameter is stored in float32, as Flax
stores them (``param_dtype``), so an optimiser updates float32 weights and
small steps do not round away. The numerics follow Flax's at that dtype:
convolutions and dense layers run in ``dtype``, with their weights and
biases rounded to it inside ``forward`` (Flax rounds per op, to the same
values); GroupNorm normalises in float32 with float32 scale and bias and
casts its output to ``dtype``; the embedding LayerNorm and the hash head
always run in float32, as the reference's do.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from hashgan_tpu_torch.utils.profiling import span

_FLAX_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2


class HashHead(nn.Module):
    """The b-unit tanh hash layer (the reference's replaced fc8)."""

    def __init__(self, in_features: int, bits: int):
        super().__init__()
        self.hash_fc = nn.Linear(in_features, bits)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.hash_fc(features.to(torch.float32)))


@torch.no_grad()
def init_like_flax(module: nn.Module,
                   generator: Optional[torch.Generator] = None) -> None:
    """Flax's initialisers: truncated lecun-normal kernels (fan-in of one
    group for grouped convolutions), zero biases, unit norm scales,
    N(0, 0.01) hash layer, all float32. Draws on the CPU from ``generator``
    (seeded by the caller) in module order; call before moving the module to
    another device."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if name == "hash.hash_fc":
                nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
            else:
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _FLAX_TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def conv(h: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype,
         same: bool = True) -> torch.Tensor:
    """``layer`` on NCHW ``h`` in ``dtype`` with Flax's padding: VALID, or
    SAME, which pads ``(out - 1) * stride + k - n`` in total with the odd
    element at the end (out = ceil(n / stride))."""
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    pads = []
    if same:
        for n, k, s in zip(h.shape[:1:-1], layer.kernel_size[::-1],
                           layer.stride[::-1]):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
    if pads and pads[0] == pads[1] == pads[2] == pads[3]:
        return F.conv2d(h, w, b, layer.stride, pads[0], 1, layer.groups)
    if any(pads):
        h = F.pad(h, pads)
    return F.conv2d(h, w, b, layer.stride, 0, 1, layer.groups)


def group_norm(h: torch.Tensor, norm: nn.GroupNorm,
               dtype: torch.dtype) -> torch.Tensor:
    """Flax's GroupNorm at a low compute dtype: statistics, scale and bias
    in float32, the output cast to ``dtype``."""
    return norm(h.float()).to(dtype)


class SmallCNNEncoder(nn.Module):
    """3-stage conv net for 32x32-scale images (reference config 1 and 5)."""

    parts = ()  # its forward runs as one piece (``ResNetEncoder.parts``)

    def __init__(self, bits: int = 32, dim: int = 64,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bits = bits
        self.dim = dim
        self.dtype = dtype
        cin = 3
        for i, mult in enumerate((1, 2, 4)):
            ch = dim * mult
            setattr(self, f"conv{i}a", nn.Conv2d(cin, ch, 3, padding=1))
            setattr(self, f"norm{i}a", nn.GroupNorm(8, ch, eps=1e-6))
            setattr(self, f"conv{i}b", nn.Conv2d(ch, ch, 3, padding=1))
            setattr(self, f"norm{i}b", nn.GroupNorm(8, ch, eps=1e-6))
            cin = ch
        self.fc = nn.Linear(4 * dim, 4 * dim)
        self.hash = HashHead(4 * dim, bits)
        self.init_params(generator)
        self.to(device)

    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        init_like_flax(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) mean-subtracted inputs -> (B, bits) float32 codes.
        ``generator`` (the train step's) is unused: this encoder draws
        nothing."""
        dt = self.dtype
        h = (x.to(dt) / 127.5).permute(0, 3, 1, 2)
        for i in range(3):
            for half in "ab":
                h = conv(h, getattr(self, f"conv{i}{half}"), dt)
                h = F.relu(group_norm(h, getattr(self, f"norm{i}{half}"), dt))
            h = F.avg_pool2d(h, 2, 2)
        h = F.linear(h.mean(dim=(2, 3)), self.fc.weight.to(dt),
                     self.fc.bias.to(dt))
        return self.hash(F.relu(h))


class ResNetBlock(nn.Module):
    """Two 3x3 convolutions with GroupNorm(32) and a 1x1 projection skip
    where the stride or the width changes (reference ``:66-87``)."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride=stride)
        self.norm1 = nn.GroupNorm(32, features, eps=1e-6)
        self.conv2 = nn.Conv2d(features, features, 3)
        self.norm2 = nn.GroupNorm(32, features, eps=1e-6)
        self.skip = (nn.Conv2d(in_features, features, 1, stride=stride)
                     if stride != 1 or in_features != features else None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = F.relu(group_norm(conv(x, self.conv1, dtype), self.norm1, dtype))
        h = group_norm(conv(h, self.conv2, dtype), self.norm2, dtype)
        skip = x if self.skip is None else conv(x, self.skip, dtype)
        return F.relu(h + skip)


class ResNetEncoder(nn.Module):
    """ResNet-18-shaped backbone + hash head (config 4; reference
    ``:90-115``): a 3x3 stem, four stages of two blocks at widths dim x
    (1, 2, 4, 8), stride 2 from the second stage on, global mean pool, a
    float32 LayerNorm of the pooled embedding, the hash head.

    Its forward runs ``parts`` in order, each in its span: the stem
    (``enc.resnet.stem.forward``), the four stages
    (``enc.resnet.s0.forward`` to ``enc.resnet.s3.forward``) and the head
    (``enc.resnet.head.forward``: pool, LayerNorm, hash layer). Each part
    is (span name, function of h, the layers it runs); a runtime may
    replace the functions by callables of the same signature, as
    ``train/graph_step.py`` does with CUDA graphs."""

    def __init__(self, bits: int = 64, dim: int = 64,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bits = bits
        self.dim = dim
        self.dtype = dtype
        self.stem = nn.Conv2d(3, dim, 3)
        self.stem_norm = nn.GroupNorm(32, dim, eps=1e-6)
        cin = dim
        for stage, mult in enumerate((1, 2, 4, 8)):
            ch = dim * mult
            setattr(self, f"s{stage}b0",
                    ResNetBlock(cin, ch, stride=1 if stage == 0 else 2))
            setattr(self, f"s{stage}b1", ResNetBlock(ch, ch))
            cin = ch
        self.embed_norm = nn.LayerNorm(cin, eps=1e-6)
        self.hash = HashHead(cin, bits)
        init_like_flax(self, generator)
        self.to(device)
        self.parts = [
            ("enc.resnet.stem.forward", self._stem,
             (self.stem, self.stem_norm)),
            *((f"enc.resnet.s{i}.forward", partial(self._stage, i),
               (getattr(self, f"s{i}b0"), getattr(self, f"s{i}b1")))
              for i in range(4)),
            ("enc.resnet.head.forward", self._head,
             (self.embed_norm, self.hash))]

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = (x.to(dt) / 127.5).permute(0, 3, 1, 2)
        return F.relu(group_norm(conv(h, self.stem, dt), self.stem_norm, dt))

    def _stage(self, stage: int, h: torch.Tensor) -> torch.Tensor:
        for block in "01":
            h = getattr(self, f"s{stage}b{block}")(h, self.dtype)
        return h

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        return self.hash(self.embed_norm(h.mean(dim=(2, 3)).to(torch.float32)))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) mean-subtracted inputs -> (B, bits) float32 codes.
        ``generator`` (the train step's) is unused: this encoder draws
        nothing."""
        h = x
        for name, run, _ in self.parts:
            with span(name):
                h = run(h)
        return h


ARCHS = ("small_cnn", "alexnet", "resnet")


def build_encoder(arch: str, bits: int, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cpu",
                  generator: Optional[torch.Generator] = None,
                  image_size: int = 227, input_resize: int = 0) -> nn.Module:
    """The port of ``build_encoder``. ``image_size`` is the side of the
    inputs, which AlexNet needs to size fc6 (the reference's Dense infers
    it at init); with ``input_resize > 0`` AlexNet resizes its inputs to
    that side and sizes fc6 for it."""
    if arch == "small_cnn":
        return SmallCNNEncoder(bits=bits, dtype=dtype, device=device,
                               generator=generator)
    if arch == "alexnet":
        from hashgan_tpu_torch.models.alexnet import AlexNetEncoder

        return AlexNetEncoder(bits=bits, image_size=image_size, dtype=dtype,
                              input_resize=input_resize, device=device,
                              generator=generator)
    if arch == "resnet":
        return ResNetEncoder(bits=bits, dtype=dtype, device=device,
                             generator=generator)
    raise ValueError(f"unknown encoder arch {arch!r}; options: {ARCHS}")


def dtype_from_name(name: str) -> torch.dtype:
    """Config dtype names (``cfg.encoder.compute_dtype``) -> torch dtypes."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}
    if name not in table:
        raise ValueError(f"unknown compute dtype {name!r}")
    return table[name]
