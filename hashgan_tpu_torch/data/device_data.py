"""Device-resident training data (port of
``hashgan_tpu/data/device_data.py``): a split parked on the device once,
batches gathered there, and the encode of a resident split.

The host feed (``data/pipeline.py``) gathers each batch in numpy and copies
it to the device every step. Here a split's uint8 images and its labels are
copied to the device once; a step sends only its row indices (B int64) and
gathers on the device (``index_select``).

Sampling. The reference draws its device indices with ``jax.random`` inside
its jitted step, so its device order is compatible only with itself
(``:18-23``). The port's device source takes ``BatchIterator.indices``
instead: the same numpy draws as the host feed, in all three modes
(uniform, ``epoch_shuffle``, ``pair_balanced``). So the device feed and the
host feed give bit-identical batches, which are also the reference's host
``BatchIterator`` batches, and a resumed run may switch feeds. Following
the host sampler has two consequences. Where ``n < batch_size *
n_batches``, the epoch mode tops a batch up with the host sampler's extra
draws (``pipeline.py``), where the reference's device source falls back to
uniform draws. Pair-balanced partners come from the host sampler's class
index: the reference's ``_class_pools`` exists only to draw them inside its
jit, and has no counterpart here.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from hashgan_tpu_torch.data.pipeline import BatchIterator, to_device
from hashgan_tpu_torch.parallel.mesh import Mesh


def _chunks(idx: np.ndarray, n_batches: int, n: int) -> list:
    """A step's rows split by position: the batch (or each batch of the
    stack) cut into ``n`` contiguous chunks; refused where ``n`` does not
    divide the batch, as ``shard_batch``."""
    b = idx.shape[0] // n_batches
    if b % n:
        raise ValueError(f"batch {b} is not divisible by the mesh size {n}")
    return [part.reshape(-1) for part in
            np.split(idx.reshape(n_batches, b), n, axis=1)]


class DeviceBatchSource:
    """A split resident on ``device`` that yields step-pure batches:
    (images (B, H, W, C) uint8, labels (B, K)), or with ``n_batches > 1``
    (the GAN's critic batches and its generator batch) ((n_batches, B, H,
    W, C), (n_batches, B, K)), drawn as one batch of ``B * n_batches``
    examples, as the host feed draws them. ``batch(step)`` is a function of
    (seed, step); ``iter(s)`` yields ``batch(s)``, ``batch(s + 1)``, ...

    With a ``mesh`` of more than one position the split is held on each of
    its distinct devices, and ``batch(step)`` is a tuple of one (images,
    labels) a position, (B / n, ...) or (n_batches, B / n, ...), gathered
    on the position's device; ``device`` is then the mesh's first."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 epoch_shuffle: bool = False, pair_balanced: bool = False,
                 n_batches: int = 1, device: torch.device | str = "cpu",
                 mesh: Optional[Mesh] = None):
        if pair_balanced and n_batches != 1:
            # balance is a contract of the encoder's pair loss; the GAN's
            # stacked batches take the plain samplers (as the reference)
            raise ValueError("pair_balanced requires n_batches == 1")
        self.batch_size = batch_size
        self.n_batches = n_batches
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None and batch_size % self.mesh.size:
            raise ValueError(f"batch {batch_size} is not divisible by the "
                             f"mesh size {self.mesh.size}")
        self.device = (torch.device(device) if mesh is None
                       else mesh.devices[0])
        self.sampler = BatchIterator(
            dataset, batch_size * n_batches, seed=seed,
            epoch_shuffle=epoch_shuffle, pair_balanced=pair_balanced)
        images = torch.from_numpy(np.ascontiguousarray(dataset.images))
        labels = torch.from_numpy(np.ascontiguousarray(dataset.labels))
        self._resident = {d: (images.to(d), labels.to(d)) for d in (
            (self.device,) if self.mesh is None else self.mesh.devices)}
        self.images, self.labels = self._resident[self.device]

    def indices(self, step: int) -> np.ndarray:
        """The (B * n_batches,) int64 rows of ``step``'s batch."""
        return self.sampler.indices(step)

    def gather(self, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch of rows ``idx``, an int64 tensor on a device that holds
        the split (the first, or a mesh position's)."""
        images, labels = self._resident[idx.device]
        images = images.index_select(0, idx)
        labels = labels.index_select(0, idx)
        if self.n_batches > 1:
            b = idx.shape[0] // self.n_batches
            images = images.view((self.n_batches, b) + images.shape[1:])
            labels = labels.view(self.n_batches, b, -1)
        return images, labels

    def batch(self, step: int):
        idx = self.indices(step)
        if self.mesh is None:
            return self.gather(to_device(idx, self.device))
        return tuple(self.gather(to_device(part, d)) for part, d in zip(
            _chunks(idx, self.n_batches, self.mesh.size), self.mesh.devices))

    def iter(self, start_step: int = 0) -> Iterator[Tuple[torch.Tensor,
                                                          torch.Tensor]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


class ResidentEncoder:
    """Encode a split held on the device, with no host->device copy a
    batch. The images are zero-padded to a multiple of the batch (the final
    batch of ``train/hash_step.py::encode_dataset`` is padded the same way)
    and copied to ``device`` once; each call slides a batch-wide window over
    them. Same slices, same padded shapes: the codes equal
    ``encode_dataset``'s bit for bit. ``Experiment`` keeps one a split."""

    def __init__(self, encode_fn: Callable, dataset, batch_size: int = 256,
                 device: torch.device | str = "cpu"):
        self.n = len(dataset)
        self.batch_size = min(batch_size, max(32, self.n))
        bs = self.batch_size
        images = np.ascontiguousarray(dataset.images)
        n_pad = -(-self.n // bs) * bs
        resident = torch.zeros((n_pad,) + images.shape[1:], dtype=torch.uint8,
                               device=device)
        resident[:self.n].copy_(torch.from_numpy(images))
        self.images = resident
        self._encode = encode_fn

    def __call__(self) -> torch.Tensor:
        """(n, bits) float32 codes on the device."""
        bs = self.batch_size
        out = [self._encode(self.images[lo:lo + bs])
               for lo in range(0, self.images.shape[0], bs)]
        return torch.cat(out)[:self.n]


def make_batch_feed(dataset, cfg, start_step: int, seed: int,
                    device: torch.device, n_batches: int = 1,
                    pair_balanced: bool = False,
                    mesh: Optional[Mesh] = None) -> Iterator:
    """The training loops' batch feed from ``start_step`` on: (images
    uint8, labels) tensors on ``device``, (B, ...), or with ``n_batches >
    1`` (the GAN's ``n_critic`` critic batches and its generator batch)
    (n_batches, B, ...) stacked from one draw of ``B * n_batches`` examples.

    With ``cfg.train.device_data`` the batches are gathered on the device
    from a resident split (``DeviceBatchSource``), except a pair-balanced
    stack, which that source refuses (the reference's switch, ``:251``).
    Otherwise ``BatchIterator`` draws and gathers on the host, and each
    batch is copied to ``device`` without blocking. Both feeds give the
    same batches bit for bit. With a ``mesh`` of more than one position
    each batch is a tuple of one (images, labels) a position, on its device
    (see ``DeviceBatchSource``)."""
    b = cfg.train.batch_size
    if cfg.train.device_data and not (pair_balanced and n_batches != 1):
        return DeviceBatchSource(
            dataset, b, seed=seed, epoch_shuffle=cfg.train.epoch_shuffle,
            pair_balanced=pair_balanced, n_batches=n_batches,
            device=device, mesh=mesh).iter(start_step)
    mesh = mesh if mesh is not None and mesh.size > 1 else None
    if mesh is not None and b % mesh.size:
        raise ValueError(f"batch {b} is not divisible by the mesh size "
                         f"{mesh.size}")
    it = BatchIterator(dataset, b * n_batches, seed=seed,
                       start_step=start_step,
                       epoch_shuffle=cfg.train.epoch_shuffle,
                       pair_balanced=pair_balanced)
    if n_batches > 1:
        it = ((images.reshape((n_batches, b) + images.shape[1:]),
               labels.reshape(n_batches, b, -1)) for images, labels in it)
    if mesh is None:
        return ((to_device(images, device), to_device(labels, device))
                for images, labels in it)
    dim = 0 if n_batches == 1 else 1
    return (tuple(
        (to_device(i, d), to_device(y, d)) for i, y, d in zip(
            np.split(images, mesh.size, axis=dim),
            np.split(labels, mesh.size, axis=dim), mesh.devices))
        for images, labels in it)
