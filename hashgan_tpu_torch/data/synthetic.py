"""Synthetic image splits with a planted class signal, and the routing of
a ``DataConfig`` to its splits (``make_splits``).

Port of the numpy path of ``hashgan_tpu/data/synthetic.py:43-124, 258-271,
330-405``: each class has a smooth template image and every sample is its
class's template (or, multi-label, a collage of its concepts' templates)
plus Gaussian noise, clipped to uint8. The same seed gives the same images,
labels and templates as the reference, bit for bit.

The port always takes the numpy path. The reference routes splits of at
least ``1 << 26`` elements (config1's 54,000-image database) to a
``jax.random`` generator whose bits the port cannot reproduce, so a
comparison with the reference runs it with ``HASHGAN_SYNTH_DEVICE=off``
(and ``HASHGAN_SYNTH_CACHE=off``, so that it writes no cache). The port
keeps no disk cache.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticImageDataset:
    images: np.ndarray      # (N, H, W, C) uint8
    labels: np.ndarray      # (N, n_classes) float32 0/1
    templates: Optional[np.ndarray] = None  # (K, H, W, C) float32 [0, 255]

    def __len__(self) -> int:
        return self.images.shape[0]

    @property
    def n_classes(self) -> int:
        return self.labels.shape[1]


def _class_templates(rng: np.random.Generator, n_classes: int, size: int,
                     channels: int) -> np.ndarray:
    """Smooth per-class templates: a low-resolution uniform field, tiled up."""
    low = max(4, size // 8)
    t = rng.uniform(0.0, 255.0, size=(n_classes, low, low, channels))
    reps = (size + low - 1) // low
    t = np.kron(t, np.ones((1, reps, reps, 1)))[:, :size, :size, :]
    return t.astype(np.float32)


def make_synthetic(n: int, n_classes: int, size: int = 32, channels: int = 3,
                   multi_label: bool = False, noise_scale: float = 40.0,
                   seed: int = 0, templates: Optional[np.ndarray] = None,
                   ) -> Tuple[SyntheticImageDataset, np.ndarray]:
    """``n`` images of randomly drawn classes. Returns (dataset, templates):
    pass the templates on so that the splits share classes."""
    rng = np.random.default_rng(seed)
    if templates is None:
        templates = _class_templates(rng, n_classes, size, channels)
    if multi_label:
        # 1-3 concepts per image; each extra concept paints its own quadrant
        labels = np.zeros((n, n_classes), dtype=np.float32)
        counts = rng.integers(1, 4, size=n)
        base = np.zeros((n, size, size, channels), dtype=np.float32)
        half = size // 2
        quads = [(0, 0), (0, half), (half, 0), (half, half)]
        for i in range(n):
            idx = rng.choice(n_classes, size=counts[i], replace=False)
            labels[i, idx] = 1.0
            base[i] = templates[idx[0]]
            for j, cls in enumerate(idx[1:]):
                y, x = (quads[int(rng.integers(0, 4))] if counts[i] > 3
                        else quads[j + 1])
                base[i, y:y + half, x:x + half] = (
                    templates[cls][y:y + half, x:x + half])
    else:
        cls = rng.integers(0, n_classes, size=n)
        labels = np.eye(n_classes, dtype=np.float32)[cls]
        base = templates[cls]
    # float32 noise, in chunks of about 2**27 elements to bound the memory
    images = np.empty(base.shape, dtype=np.uint8)
    chunk = max(1, (1 << 27) // (base.shape[1] * base.shape[2] * base.shape[3]))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        noise = rng.standard_normal(
            size=base[lo:hi].shape, dtype=np.float32) * np.float32(noise_scale)
        images[lo:hi] = np.clip(base[lo:hi].astype(np.float32) + noise,
                                0, 255).astype(np.uint8)
    return SyntheticImageDataset(images, labels, templates), templates


def synth_generation_key(cfg) -> str:
    """Identifier of the bits a synthetic geometry generates on the numpy
    path: the reference's ``synth_generation_key(cfg, device=False)``. It is
    the data-provenance record beside checkpoints (``utils/checkpoint.py``)."""
    return (
        f"v1_{cfg.image_size}x{cfg.channels}_c{cfg.n_classes}"
        f"_ml{int(cfg.multi_label)}_ns{cfg.noise_scale:g}_s{cfg.seed}"
        f"_n{cfg.n_train}-{cfg.n_query}-{cfg.n_database}"
    )


def make_splits(cfg) -> Dict[str, SyntheticImageDataset]:
    """Train, query and database splits of ``cfg`` (a ``DataConfig``), as
    the reference routes them: from the CIFAR-10 archive at
    ``cifar10_dir``; else from the three list files, all of which must be
    configured and on disk (``FileNotFoundError`` names the missing ones);
    else synthetic, with seed offsets 0, 1 and 2 and shared templates."""
    if cfg.cifar10_dir:
        from hashgan_tpu_torch.data.cifar10 import make_cifar10_splits

        return make_cifar10_splits(cfg.cifar10_dir, cfg)
    lists = {("train", "train_list"): cfg.train_list,
             ("query", "test_list"): cfg.test_list,
             ("database", "database_list"): cfg.database_list}
    if any(lists.values()):
        # a half-configured set would mix synthetic splits into real data
        problems = [f"{name}={path!r}" for (_, name), path in lists.items()
                    if path is None or not os.path.exists(path)]
        if problems:
            raise FileNotFoundError(
                "list-file datasets need all of train/test/database lists "
                "configured and on disk; missing: " + ", ".join(problems))
        from hashgan_tpu_torch.data.loader import load_list_dataset

        return {split: load_list_dataset(path, cfg)
                for (split, _), path in lists.items()}
    templates = None
    out: Dict[str, SyntheticImageDataset] = {}
    for split, n, seed_off in (("train", cfg.n_train, 0),
                               ("query", cfg.n_query, 1),
                               ("database", cfg.n_database, 2)):
        out[split], templates = make_synthetic(
            max(n, 1), cfg.n_classes, size=cfg.image_size,
            channels=cfg.channels, multi_label=cfg.multi_label,
            noise_scale=cfg.noise_scale, seed=cfg.seed + seed_off,
            templates=templates)
    return out
