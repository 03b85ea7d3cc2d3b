"""Synthetic single-label image splits with a planted class signal.

Port of the numpy path of ``hashgan_tpu/data/synthetic.py:43-124``: each
class has a smooth template image and every sample is its class's template
plus Gaussian noise, clipped to uint8. The same seed gives the same images,
labels and templates as the reference, bit for bit. Multi-label splits and
the reference's device generator are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

CHANNELS = 3
NOISE_SCALE = np.float32(40.0)  # the reference's DataConfig.noise_scale


@dataclasses.dataclass
class SyntheticImageDataset:
    images: np.ndarray      # (N, H, W, C) uint8
    labels: np.ndarray      # (N, n_classes) float32 one-hot
    templates: np.ndarray   # (n_classes, H, W, C) float32 in [0, 255]

    def __len__(self) -> int:
        return self.images.shape[0]


def _class_templates(rng: np.random.Generator, n_classes: int,
                     size: int) -> np.ndarray:
    """Smooth per-class templates: a low-resolution uniform field, tiled up."""
    low = max(4, size // 8)
    t = rng.uniform(0.0, 255.0, size=(n_classes, low, low, CHANNELS))
    reps = (size + low - 1) // low
    t = np.kron(t, np.ones((1, reps, reps, 1)))[:, :size, :size, :]
    return t.astype(np.float32)


def make_synthetic(n: int, n_classes: int, size: int = 32, seed: int = 0,
                   templates: Optional[np.ndarray] = None,
                   ) -> Tuple[SyntheticImageDataset, np.ndarray]:
    """``n`` RGB images of uniformly drawn classes, with the reference's
    default noise scale. Returns (dataset, templates): pass the templates on
    so that query and database splits share classes."""
    rng = np.random.default_rng(seed)
    if templates is None:
        templates = _class_templates(rng, n_classes, size)
    cls = rng.integers(0, n_classes, size=n)
    labels = np.eye(n_classes, dtype=np.float32)[cls]
    base = templates[cls]
    # float32 noise, in chunks of about 2**27 elements to bound the memory
    images = np.empty(base.shape, dtype=np.uint8)
    chunk = max(1, (1 << 27) // (size * size * CHANNELS))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        noise = rng.standard_normal(size=base[lo:hi].shape, dtype=np.float32)
        images[lo:hi] = np.clip(base[lo:hi] + noise * NOISE_SCALE,
                                0, 255).astype(np.uint8)
    return SyntheticImageDataset(images, labels, templates), templates
