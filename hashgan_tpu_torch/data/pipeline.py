"""Host-side batching with deterministic, resumable sampling.

Port of ``hashgan_tpu/data/pipeline.py:21-128, 183-202``. The sampling is
numpy, copied as it is, so the same ``(seed, step)`` gives bit-identical
batches to the reference's: a batch is a pure function of (seed, step), and
a resumed run replays the exact data order. ``BatchIterator.indices`` gives
a step's rows alone: the device feed (``data/device_data.py``) gathers the
same rows from a split held on the device.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch


class BatchIterator:
    """Yields (images uint8 (B, H, W, C), labels float32 (B, K)) batches.

    - with replacement (default): a uniform draw per step;
    - ``epoch_shuffle``: a permutation per epoch without replacement,
      epoch = step // batches_per_epoch, seeded by (seed, epoch);
    - ``pair_balanced``: the first half of the batch is uniform, the second
      half pairs each first-half item with an example sharing >= 1 label.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 start_step: int = 0, epoch_shuffle: bool = False,
                 pair_balanced: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.step = start_step
        self.epoch_shuffle = epoch_shuffle
        self.pair_balanced = pair_balanced
        self._perm_cache: Optional[Tuple[int, np.ndarray]] = None
        self._class_index: Optional[tuple] = None  # (concat, offsets, sizes)

    def _partners(self, rng: np.random.Generator, idx: np.ndarray) -> np.ndarray:
        """A partner sharing >= 1 active label for each item; items with no
        active label partner with themselves."""
        labels = self.dataset.labels
        if self._class_index is None:
            act = labels > 0.5
            _, cols = np.nonzero(act.T)  # item ids, grouped by class
            sizes = act.sum(axis=0).astype(np.int64)
            offsets = np.concatenate([[0], np.cumsum(sizes)])
            self._class_index = (cols, offsets, sizes)
        concat, offsets, sizes = self._class_index
        if concat.size == 0:
            return idx
        a = labels[idx] > 0.5
        n_active = a.sum(axis=1)
        u = rng.integers(0, np.maximum(n_active, 1))
        c = np.argmax(np.cumsum(a, axis=1) > u[:, None], axis=1)
        pick = rng.integers(0, np.maximum(sizes[c], 1))
        partners = concat[offsets[c] + pick]
        return np.where(n_active > 0, partners, idx)

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        if self._perm_cache is not None and self._perm_cache[0] == epoch:
            return self._perm_cache[1]
        rng = np.random.default_rng((self.seed, epoch, 0xE70C))
        perm = rng.permutation(len(self.dataset))
        self._perm_cache = (epoch, perm)
        return perm

    def indices(self, step: int) -> np.ndarray:
        """The (batch_size,) int64 row indices of ``step``'s batch."""
        n = len(self.dataset)
        if self.pair_balanced:
            rng = np.random.default_rng((self.seed, step, 0xBA1A))
            half = self.batch_size // 2
            anchors = rng.integers(0, n, size=self.batch_size - half)
            partners = self._partners(rng, anchors[:half])
            return np.concatenate([anchors, partners])
        if self.epoch_shuffle:
            bpe = max(1, n // self.batch_size)  # drop the ragged remainder
            epoch, pos = divmod(step, bpe)
            idx = self._epoch_perm(epoch)[
                pos * self.batch_size:(pos + 1) * self.batch_size]
            if idx.shape[0] < self.batch_size:  # dataset smaller than batch
                rng = np.random.default_rng((self.seed, step, 0xF111))
                extra = rng.integers(0, n, size=self.batch_size - idx.shape[0])
                idx = np.concatenate([idx, extra])
            return idx
        rng = np.random.default_rng((self.seed, step))
        return rng.integers(0, n, size=self.batch_size)

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        idx = self.indices(step)
        return self.dataset.images[idx], self.dataset.labels[idx]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        out = self.batch(self.step)
        self.step += 1
        return out


def epoch_batches(dataset, batch_size: int
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """A full sweep in order: (images, labels, valid_mask), the final batch
    zero-padded to ``batch_size`` as in the reference."""
    n = len(dataset)
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        imgs = dataset.images[lo:hi]
        labs = dataset.labels[lo:hi]
        mask = np.ones(hi - lo, dtype=bool)
        if hi - lo < batch_size:
            pad = batch_size - (hi - lo)
            imgs = np.concatenate(
                [imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
            labs = np.concatenate(
                [labs, np.zeros((pad,) + labs.shape[1:], labs.dtype)])
            mask = np.concatenate([mask, np.zeros(pad, dtype=bool)])
        yield imgs, labs, mask


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory with a
    non-blocking copy on a GPU, so the copy queues behind the running step
    instead of stalling the host."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def __getattr__(name: str):
    # ``make_batch_feed`` lives in data/device_data.py beside the device
    # feed it switches to; imported lazily, as that module imports this one
    if name == "make_batch_feed":
        from hashgan_tpu_torch.data.device_data import make_batch_feed

        return make_batch_feed
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
