"""Inputs and weights made from ``--seed``, on the device, in few calls.

Each purpose draws from a stream of its own (``TAG_*``), so a cell's
gallery does not change when its traffic draws more or less.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

MASK64 = (1 << 64) - 1

TAG_GALLERY = 1
TAG_QUERIES = 2
TAG_ORDER = 3
TAG_SAMPLE = 4
TAG_WEIGHTS = 5
TAG_TRAIN = 8


def rng(seed: int, tag: int) -> np.random.Generator:
    """A numpy stream of (seed, tag); any whole seed, negative or past 64
    bits, is taken modulo 2**64."""
    return np.random.default_rng([seed & MASK64, tag])


def torch_generator(seed: int, tag: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded from (seed, tag)."""
    state = np.random.SeedSequence([seed & MASK64, tag]).generate_state(
        1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) >> 1)
    return gen


def clustered_codes(gen: torch.Generator, centres: torch.Tensor, n: int,
                    flip_share: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` codes clustered as a trained encoder's are: each takes the
    signs of a class centre drawn uniformly from ``centres`` (K, bits) of
    +-1, each bit flipped with probability ``flip_share``, at magnitudes in
    [0.05, 1) (never 0, so every sign is defined). Returns (codes (n, bits)
    float32, classes (n,) int64) on the centres' device."""
    k, bits = centres.shape
    dev = centres.device
    classes = torch.randint(0, k, (n,), generator=gen, device=dev)
    flips = torch.rand((n, bits), generator=gen, device=dev) < flip_share
    mags = torch.rand((n, bits), generator=gen, device=dev) * 0.95 + 0.05
    signs = centres[classes] * torch.where(flips, -1.0, 1.0)
    return signs * mags, classes


def class_centres(gen: torch.Generator, k: int, bits: int,
                  device) -> torch.Tensor:
    return torch.randint(0, 2, (k, bits), generator=gen,
                         device=device).float() * 2 - 1


def one_hot(classes: torch.Tensor, k: int) -> np.ndarray:
    """(n, k) float32 0/1 labels on the host, as a split's labels are."""
    out = np.zeros((classes.shape[0], k), dtype=np.float32)
    out[np.arange(classes.shape[0]), classes.cpu().numpy()] = 1.0
    return out


def seed_parameters(module: torch.nn.Module, gen: torch.Generator
                    ) -> Dict[str, torch.Tensor]:
    """Overwrite every parameter of ``module`` from one normal draw on its
    device: matrices and kernels at std 1/sqrt(fan-in), biases at std 0.02,
    other vectors (norm scales) at 1 + 0.1 x. Returns the benchmark's own
    float32 copy of each, by name, to hand to the reference."""
    named = list(module.named_parameters())
    dev = named[0][1].device
    flat = torch.randn(sum(p.numel() for _, p in named), generator=gen,
                       device=dev)
    out, offset = {}, 0
    with torch.no_grad():
        for name, p in named:
            x = flat[offset:offset + p.numel()].view(p.shape)
            offset += p.numel()
            if p.dim() >= 2:
                w = x / math.sqrt(p[0].numel())
            elif name.endswith("bias"):
                w = x * 0.02
            else:
                w = 1.0 + 0.1 * x
            out[name] = w.float().clone()
            p.copy_(w)
    return out


class Split:
    """A train split as the program's feeds read one: ``images`` (N, H, W,
    3) uint8 and ``labels`` (N, K) float32 one-hot, on the host."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        self.images, self.labels = images, labels

    def __len__(self) -> int:
        return self.images.shape[0]


def template_images(gen: torch.Generator, n: int, k: int, side: int,
                    noise: float = 40.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` images of ``k`` classes drawn uniformly: each class a smooth
    template (a 4x4 field of uniform colours, upsampled) plus Gaussian
    noise of std ``noise``, clipped to uint8, as the HashGAN port's
    synthetic stand-in for CIFAR-10 draws them. Returns (images (n, side,
    side, 3) uint8, classes (n,) int64) on the generator's device."""
    dev = gen.device
    low = torch.rand((k, 3, 4, 4), generator=gen, device=dev) * 255.0
    templates = torch.nn.functional.interpolate(
        low, size=(side, side), mode="nearest").permute(0, 2, 3, 1)
    classes = torch.randint(0, k, (n,), generator=gen, device=dev)
    x = templates[classes] + noise * torch.randn(
        (n, side, side, 3), generator=gen, device=dev)
    return x.round().clamp(0, 255).to(torch.uint8), classes
