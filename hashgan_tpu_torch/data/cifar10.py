"""The standard CIFAR-10 archive as train / query / database splits (port
of ``hashgan_tpu/data/cifar10.py``; numpy, copied as it is, so the same
archive and seed give the reference's splits bit for bit).

Both distribution formats are read:

- ``cifar-10-batches-py``: pickles ``data_batch_1`` .. ``data_batch_5`` and
  ``test_batch``, each ``{b"data": (10000, 3072) uint8, b"labels": [int]}``;
- ``cifar-10-batches-bin``: ``data_batch_1.bin`` .. ``test_batch.bin``,
  rows of one label byte and 3,072 image bytes (R, G, B planes).

Per class, ``n_query / 10`` query and ``n_train / 10`` train images are
drawn without replacement by ``cfg.seed``; the rest is the database
(1,000 / 5,000 / 54,000 at the defaults), capped at ``n_database``.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np

from hashgan_tpu_torch.data.synthetic import SyntheticImageDataset

_PY_BATCHES = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
_BIN_BATCHES = [name + ".bin" for name in _PY_BATCHES]
_ROW_BYTES = 1 + 3072  # binary format: a label byte and 32 * 32 * 3 pixels


def _decode_images(flat: np.ndarray) -> np.ndarray:
    """(N, 3072) planar R, G, B rows -> (N, 32, 32, 3) uint8 NHWC."""
    return flat.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


def load_cifar10_dir(root: str) -> Tuple[np.ndarray, np.ndarray]:
    """All 60,000 images and integer labels of an extracted archive, in
    either format; ``root`` is the archive's directory or its parent (which
    holds ``cifar-10-batches-py`` or ``-bin``)."""
    for sub in ("", "cifar-10-batches-py", "cifar-10-batches-bin"):
        d = os.path.join(root, sub) if sub else root
        if os.path.exists(os.path.join(d, _PY_BATCHES[0])):
            return _load_py(d)
        if os.path.exists(os.path.join(d, _BIN_BATCHES[0])):
            return _load_bin(d)
    raise FileNotFoundError(
        f"no CIFAR-10 batches (python or binary format) under {root!r}")


def _load_py(d: str) -> Tuple[np.ndarray, np.ndarray]:
    imgs, labs = [], []
    for name in _PY_BATCHES:
        # the archive's own pickles, named by the configuration
        with open(os.path.join(d, name), "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        data = np.asarray(batch[b"data"], dtype=np.uint8)
        if data.shape[1] != 3072:
            raise ValueError(f"{name}: expected 3072 bytes/row, got "
                             f"{data.shape}")
        imgs.append(_decode_images(data))
        labs.append(np.asarray(batch[b"labels"], dtype=np.int64))
    return np.concatenate(imgs), np.concatenate(labs)


def _load_bin(d: str) -> Tuple[np.ndarray, np.ndarray]:
    imgs, labs = [], []
    for name in _BIN_BATCHES:
        raw = np.fromfile(os.path.join(d, name), dtype=np.uint8)
        if raw.size % _ROW_BYTES:
            raise ValueError(f"{name}: size {raw.size} not a multiple of "
                             f"{_ROW_BYTES}")
        rows = raw.reshape(-1, _ROW_BYTES)
        labs.append(rows[:, 0].astype(np.int64))
        imgs.append(_decode_images(rows[:, 1:]))
    return np.concatenate(imgs), np.concatenate(labs)


def make_cifar10_splits(root: str, cfg) -> Dict[str, SyntheticImageDataset]:
    """The protocol's splits of the archive at ``root`` under ``cfg`` (a
    ``DataConfig``): per class a seeded shuffle gives the query images,
    then the train images, then the database (disjoint from both); a
    database larger than ``n_database`` is cut to a seeded subset."""
    images, int_labels = load_cifar10_dir(root)
    n_classes = 10
    per_q = cfg.n_query // n_classes
    per_t = cfg.n_train // n_classes
    rng = np.random.default_rng(cfg.seed)
    q_idx, t_idx, db_idx = [], [], []
    for c in range(n_classes):
        pool = np.flatnonzero(int_labels == c)
        if pool.size < per_q + per_t:
            raise ValueError(f"class {c}: {pool.size} examples < query+train "
                             f"{per_q + per_t}")
        pool = pool[rng.permutation(pool.size)]
        q_idx.append(pool[:per_q])
        t_idx.append(pool[per_q:per_q + per_t])
        db_idx.append(pool[per_q + per_t:])
    out: Dict[str, SyntheticImageDataset] = {}
    onehot = np.eye(n_classes, dtype=np.float32)
    for split, parts, cap in (("train", t_idx, cfg.n_train),
                              ("query", q_idx, cfg.n_query),
                              ("database", db_idx, cfg.n_database)):
        idx = np.sort(np.concatenate(parts))
        if cap and idx.size > cap:
            idx = np.sort(idx[rng.permutation(idx.size)[:cap]])
        out[split] = SyntheticImageDataset(images=images[idx],
                                           labels=onehot[int_labels[idx]])
    return out
