"""Hash encoders F: image -> b continuous codes in (-1, 1).

Port of ``hashgan_tpu/models/encoders.py:27-63, 118-132``. The public API
takes NHWC inputs, as the reference does, and permutes to NCHW inside. The
layers match Flax's: 3x3 convolutions with SAME padding (``padding=1``),
GroupNorm with Flax's epsilon of 1e-6 (torch's default is 1e-5), 2x2 VALID
average pooling. Parameters carry over from a Flax tree with
``models/convert.py::flax_to_torch``.

``dtype`` is the compute dtype of the backbone (the presets use bfloat16,
``configs/config.py:108``). Every parameter is stored in float32, as Flax
stores them (``param_dtype``), so an optimiser updates float32 weights and
small steps do not round away. The numerics follow Flax's at that dtype:
convolutions and the ``fc`` layer run in ``dtype``, with their weights and
biases rounded to it inside ``forward`` (Flax rounds per op, to the same
values); GroupNorm normalises in float32 with float32 scale and bias and
casts its output to ``dtype``; the hash head always runs in float32, as the
reference's ``HashHead`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

_FLAX_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2


class HashHead(nn.Module):
    """The b-unit tanh hash layer (the reference's replaced fc8)."""

    def __init__(self, in_features: int, bits: int):
        super().__init__()
        self.hash_fc = nn.Linear(in_features, bits)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.hash_fc(features.to(torch.float32)))


class SmallCNNEncoder(nn.Module):
    """3-stage conv net for 32x32-scale images (reference config 1 and 5)."""

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

    @torch.no_grad()
    def init_params(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initialisers: truncated lecun-normal kernels, zero biases,
        unit GroupNorm scales, N(0, 0.01) hash layer, all float32. Draws on
        the CPU from ``generator`` (seeded by the caller); call before
        moving the module to another device."""
        for name, m in self.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                if name == "hash.hash_fc":
                    nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
                else:
                    fan_in = m.weight[0].numel()
                    std = math.sqrt(1.0 / fan_in) / _FLAX_TRUNC_STD
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                          2 * std, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) mean-subtracted inputs -> (B, bits) float32 codes."""
        dt = self.dtype
        h = (x.to(dt) / 127.5).permute(0, 3, 1, 2)
        for i in range(3):
            for half in "ab":
                conv = getattr(self, f"conv{i}{half}")
                h = F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt),
                             padding=1)
                h = getattr(self, f"norm{i}{half}")(h.float()).to(dt)
                h = F.relu(h)
            h = F.avg_pool2d(h, 2, 2)
        h = F.linear(h.mean(dim=(2, 3)), self.fc.weight.to(dt),
                     self.fc.bias.to(dt))
        return self.hash(F.relu(h))


def build_encoder(arch: str, bits: int, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cpu",
                  generator: Optional[torch.Generator] = None) -> nn.Module:
    """The port of ``build_encoder``; only ``small_cnn`` exists so far."""
    if arch == "small_cnn":
        return SmallCNNEncoder(bits=bits, dtype=dtype, device=device,
                               generator=generator)
    if arch in ("alexnet", "resnet"):
        raise NotImplementedError(
            f"encoder arch {arch!r} is not ported yet (ROADMAP.md, queue 1: "
            "AlexNet and ResNet encoders)"
        )
    raise ValueError(f"unknown encoder arch {arch!r}")


def dtype_from_name(name: str) -> torch.dtype:
    """Config dtype names (``cfg.encoder.compute_dtype``) -> torch dtypes."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}
    if name not in table:
        raise ValueError(f"unknown compute dtype {name!r}")
    return table[name]
