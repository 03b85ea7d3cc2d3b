"""AlexNet hash encoder and the bvlc_alexnet.npy weight loader (port of
``hashgan_tpu/models/alexnet.py``).

conv1 (11x11, stride 4, VALID) -> ReLU -> LRN -> max-pool -> conv2 (5x5,
two groups) -> ReLU -> LRN -> max-pool -> conv3 -> conv4 (two groups) ->
conv5 (two groups) -> max-pool -> fc6 -> fc7 (ReLU and dropout after each)
-> float32 LayerNorm -> hash head. As in the reference:

- conv2-5 use Flax's SAME padding; the pools are 3x3 stride-2 VALID and are
  skipped where the map is under 3x3, so a 64x64 input reaches fc6 as
  2 x 2 x 256 = 1,024 features and a 227x227 one as 6 x 6 x 256 = 9,216;
- torch needs fc6's width at construction, so the module takes the input
  side (``image_size``), or ``input_resize`` where that is set: inputs of
  another side are then resized to it (bilinear, antialiased), after the
  cast to the compute dtype, as the reference does;
- the conv5 map is flattened in NHWC order (h, w, c), as Flax flattens it,
  so fc6's weight rows keep the reference's (and bvlc_alexnet.npy's) order;
- ``embed_norm`` is Flax's LayerNorm, epsilon 1e-6, in float32;
- dropout acts in train mode only. Its masks come from uniform noise
  (``dropout_noise``): drawn on the input's device from a generator seeded
  with one seed, which the train step draws from its per-step generator, so
  a step stays a pure function of its inputs. The step draws the noise
  before the forward and passes it in (``dropout=``); a CUDA graph of the
  step reads it from static buffers filled before each replay. Given only
  a ``generator``, ``forward`` draws the seed and the noise itself.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from hashgan_tpu_torch.data.preprocess import resize_images
from hashgan_tpu_torch.models.encoders import HashHead, conv, init_like_flax
from hashgan_tpu_torch.models.layers import local_response_norm


HIDDEN = 4096  # fc6's and fc7's width


def draw_dropout_seed(generator: torch.Generator) -> int:
    """The seed of a step's dropout noise, one draw from its generator."""
    return int(torch.randint(0, 1 << 62, (), generator=generator))


def dropout_noise(seed: int, rows: int, device: torch.device | str,
                  out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fc6's and fc7's dropout noise for ``rows`` inputs: two (rows,
    HIDDEN) float32 uniform draws on ``device``, in that order, from a
    generator seeded with ``seed`` (into ``out`` where given)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = out or (None, None)
    return tuple(torch.rand((rows, HIDDEN), device=device, generator=gen,
                            out=o) for o in out)


def _pool_side(n: int) -> int:
    """Side after ``_maxpool``: 3x3 stride-2 VALID, skipped under 3."""
    return n if n < 3 else (n - 3) // 2 + 1


def feature_side(image_size: int) -> int:
    """Side of conv5's map (after its pool) for square inputs."""
    n = _pool_side((image_size - 11) // 4 + 1)   # conv1, pool
    return _pool_side(_pool_side(n))             # conv2, pool; conv3-5, pool


def _maxpool(h: torch.Tensor) -> torch.Tensor:
    if min(h.shape[2], h.shape[3]) < 3:
        return h
    return F.max_pool2d(h, 3, 2)


class AlexNetEncoder(nn.Module):
    parts = ()  # its forward runs as one piece (``ResNetEncoder.parts``)

    def __init__(self, bits: int = 48, image_size: int = 227,
                 dtype: torch.dtype = torch.float32, dropout_rate: float = 0.5,
                 input_resize: int = 0, device: torch.device | str = "cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        image_size = input_resize or image_size
        if image_size < 11:
            raise ValueError(f"AlexNet needs inputs of at least 11x11, got "
                             f"{image_size}")
        self.bits = bits
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.input_resize = input_resize
        self.conv1 = nn.Conv2d(3, 96, 11, stride=4)
        self.conv2 = nn.Conv2d(96, 256, 5, groups=2)
        self.conv3 = nn.Conv2d(256, 384, 3)
        self.conv4 = nn.Conv2d(384, 384, 3, groups=2)
        self.conv5 = nn.Conv2d(384, 256, 3, groups=2)
        self.fc6 = nn.Linear(feature_side(image_size) ** 2 * 256, HIDDEN)
        self.fc7 = nn.Linear(HIDDEN, HIDDEN)
        self.embed_norm = nn.LayerNorm(HIDDEN, eps=1e-6)
        self.hash = HashHead(HIDDEN, bits)
        init_like_flax(self, generator)
        self.to(device)

    def _dropout(self, h: torch.Tensor,
                 noise: Optional[torch.Tensor]) -> torch.Tensor:
        if noise is None:
            return h
        keep_prob = 1.0 - self.dropout_rate
        return torch.where(noise < keep_prob, h / keep_prob,
                           torch.zeros_like(h))

    def _dense(self, h: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        dt = self.dtype
        return F.linear(h, layer.weight.to(dt), layer.bias.to(dt))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                dropout: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """(B, H, W, 3) mean-subtracted inputs -> (B, bits) float32 codes.
        In train mode the dropout masks come from ``dropout`` (fc6's and
        fc7's noise, ``dropout_noise``) or, without it, from noise seeded
        by a draw from ``generator``; one of the two is then required."""
        noise = (None, None)
        if self.training and self.dropout_rate > 0.0:
            if dropout is None:
                if generator is None:
                    raise ValueError("AlexNet's dropout in train mode draws "
                                     "from the step's generator: pass "
                                     "generator= or dropout=")
                dropout = dropout_noise(draw_dropout_seed(generator),
                                        x.shape[0], x.device)
            noise = dropout
        dt = self.dtype
        h = x.to(dt)
        if self.input_resize and h.shape[1] != self.input_resize:
            h = resize_images(h, self.input_resize)
        h = h.permute(0, 3, 1, 2)
        h = F.relu(conv(h, self.conv1, dt, same=False))
        h = _maxpool(local_response_norm(h, dim=1))
        h = F.relu(conv(h, self.conv2, dt))
        h = _maxpool(local_response_norm(h, dim=1))
        for layer in (self.conv3, self.conv4, self.conv5):
            h = F.relu(conv(h, layer, dt))
        h = _maxpool(h)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # Flax's (h, w, c)
        h = self._dropout(F.relu(self._dense(h, self.fc6)), noise[0])
        h = self._dropout(F.relu(self._dense(h, self.fc7)), noise[1])
        return self.hash(self.embed_norm(h.to(torch.float32)))


_NPY_LAYERS = ("conv1", "conv2", "conv3", "conv4", "conv5", "fc6", "fc7")


def load_bvlc_weights(state_dict: Dict[str, torch.Tensor],
                      npy_path: str) -> Dict[str, torch.Tensor]:
    """Copy bvlc_alexnet.npy weights into an AlexNetEncoder state dict.

    The npy holds ``{layer: [W, b]}`` with conv W in HWIO and fc W as
    (in, out), the reference's schema. Returns a new state dict; layers
    whose shapes do not match (fc6 at inputs other than 227x227) keep their
    values, as in the reference."""
    if not os.path.exists(npy_path):
        raise FileNotFoundError(npy_path)
    blobs = np.load(npy_path, allow_pickle=True, encoding="latin1").item()
    loaded = dict(state_dict)
    for name in _NPY_LAYERS:
        key_w, key_b = f"{name}.weight", f"{name}.bias"
        if name not in blobs or key_w not in loaded:
            continue
        w = torch.from_numpy(np.array(blobs[name][0], dtype=np.float32))
        b = torch.from_numpy(np.array(blobs[name][1], dtype=np.float32))
        w = w.permute(3, 2, 0, 1) if w.dim() == 4 else w.t()
        if w.shape == loaded[key_w].shape and b.shape == loaded[key_b].shape:
            loaded[key_w] = w.contiguous().to(loaded[key_w].device)
            loaded[key_b] = b.to(loaded[key_b].device)
    return loaded
