"""End-to-end query engine: images (or codes) -> ranked neighbours.

Port of ``hashgan_tpu/index/engine.py`` for one device: encode -> pack ->
exact top-k, and a pipelined serving loop over the same steps.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from hashgan_tpu_torch.index.gallery import PackedGallery
from hashgan_tpu_torch.ops.pack import pack_codes
from hashgan_tpu_torch.train.hash_step import make_encode_fn


@dataclasses.dataclass
class QueryResult:
    distances: np.ndarray       # (Q, k) int32 Hamming distances
    indices: np.ndarray         # (Q, k) int32 gallery ids
    labels: Optional[np.ndarray] = None  # (Q, k, n_classes) neighbour labels


class QueryEngine:
    """encode -> pack -> exact top-k, wrapped for serving.

    ``encoder=None`` serves code queries only (a gallery without a model).
    The reference takes ``params`` as well; here they live in the module,
    which must sit on the gallery's device."""

    def __init__(self, encoder: Optional[nn.Module], gallery: PackedGallery,
                 cfg=None):
        self.encoder = encoder
        self.gallery = gallery
        self._encode = (make_encode_fn(encoder, cfg) if encoder is not None
                        else None)

    def encode(self, images_u8) -> torch.Tensor:
        if self._encode is None:
            raise ValueError(
                "this QueryEngine was built without an encoder (code-only "
                "serving); query with codes, or construct it with a model"
            )
        return self._encode(images_u8)

    def query_codes(self, codes, k: int = 100, mode: str = "exact",
                    with_labels: bool = False) -> QueryResult:
        codes = torch.as_tensor(codes, dtype=torch.float32).to(
            self.gallery.device)
        d, i = self.gallery.topk(pack_codes(codes), k=k, mode=mode)
        d, i = d.cpu().numpy(), i.cpu().numpy()
        labels = None
        if with_labels:
            # Padding sentinels (index >= n) must not surface a real item's
            # labels: zero their rows instead of clipping into the gallery.
            valid = i < self.gallery.n
            safe = np.where(valid, i, 0)
            labels = np.where(
                valid[:, :, None], self.gallery.labels[safe], 0.0
            ).astype(self.gallery.labels.dtype)
        return QueryResult(distances=d, indices=i, labels=labels)

    def query_images(self, images_u8, k: int = 100, mode: str = "exact",
                     with_labels: bool = False) -> QueryResult:
        return self.query_codes(self.encode(images_u8), k=k, mode=mode,
                                with_labels=with_labels)


class ServingPipeline:
    """Pipelined serving: each batch's encode -> pack -> scan -> top-k is
    enqueued on the device's stream by ``submit`` with no host sync, and its
    results are copied into pinned host buffers behind an event. ``drain``
    waits for the OLDEST batch's event only, so the host prepares and
    enqueues batch t+1 while the device still runs batch t. At most
    ``depth`` batches are in flight in ``map_batches``. The top-k is the
    gallery's exact one (``PackedGallery.topk``), which refuses what the
    port does not cover.

    On a CPU gallery the same steps run synchronously (there is no stream
    to overlap with)."""

    def __init__(self, engine: QueryEngine, k: int = 100, depth: int = 2):
        if engine._encode is None:
            raise ValueError(
                "ServingPipeline needs an encoder (QueryEngine built "
                "without one serves code queries via query_codes)"
            )
        self.engine = engine
        self.k = k
        self.depth = depth
        self._inflight: collections.deque = collections.deque()

    def _step(self, images: torch.Tensor):
        pq = pack_codes(self.engine.encode(images))
        return self.engine.gallery.topk(pq, k=self.k)

    def submit(self, images_u8: np.ndarray) -> None:
        """Enqueue a batch (asynchronous on a GPU); results queue until
        drained."""
        device = self.engine.gallery.device
        host = torch.from_numpy(np.ascontiguousarray(images_u8))
        if device.type != "cuda":
            d, i = self._step(host)
            self._inflight.append((d.numpy(), i.numpy(), None))
            return
        images = host.pin_memory().to(device, non_blocking=True)
        d, i = self._step(images)
        d_host = torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
        i_host = torch.empty(i.shape, dtype=i.dtype, pin_memory=True)
        d_host.copy_(d, non_blocking=True)
        i_host.copy_(i, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        self._inflight.append((d_host, i_host, done))

    def drain(self) -> QueryResult:
        """Wait for the OLDEST in-flight batch and return it."""
        d, i, done = self._inflight.popleft()
        if done is not None:
            done.synchronize()
            d, i = d.numpy(), i.numpy()
        return QueryResult(distances=d, indices=i)

    def map_batches(self, batches):
        """Stream batches through the pipeline, yielding results in order
        with at most ``depth`` batches in flight."""
        for b in batches:
            self.submit(b)
            while len(self._inflight) >= self.depth:
                yield self.drain()
        while self._inflight:
            yield self.drain()
