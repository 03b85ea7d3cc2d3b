"""End-to-end query engine: images (or codes) -> ranked neighbours.

Port of ``hashgan_tpu/index/engine.py``: encode -> pack -> top-k, and a
pipelined serving loop over the same steps, over a gallery on one device or
split over a mesh (``PackedGallery.mesh``). The encoder sits on the
gallery's ``device``, the mesh's first device for a sharded gallery.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from hashgan_tpu_torch.index.gallery import PackedGallery
from hashgan_tpu_torch.ops.mxu_large_k import MAX_K, grouped_topk
from hashgan_tpu_torch.ops.mxu_scan import check_mode
from hashgan_tpu_torch.ops.pack import pack_codes
from hashgan_tpu_torch.parallel.mesh import Mesh
from hashgan_tpu_torch.parallel.sharded_scan import (
    sharded_mxu_topk,
    sharded_mxu_topk_large,
)
from hashgan_tpu_torch.train.hash_step import make_encode_fn
from hashgan_tpu_torch.utils.profiling import count, span


@dataclasses.dataclass
class QueryResult:
    distances: np.ndarray       # (Q, k) int32 Hamming distances
    indices: np.ndarray         # (Q, k) int32 gallery ids
    labels: Optional[np.ndarray] = None  # (Q, k, n_classes) neighbour labels


class QueryEngine:
    """encode -> pack -> top-k (``PackedGallery.topk``), wrapped for serving.

    ``encoder=None`` serves code queries only (a gallery without a model).
    The reference takes ``params`` as well; here they live in the module,
    which must sit on the gallery's device."""

    def __init__(self, encoder: Optional[nn.Module], gallery: PackedGallery,
                 cfg=None):
        self.encoder = encoder
        self.gallery = gallery
        self.calls = 0  # queries answered: the id of each one's spans
        self._encode = (make_encode_fn(encoder, cfg) if encoder is not None
                        else None)

    @classmethod
    def from_artifacts(cls, cfg, workdir: str, gallery_path: str,
                       device: Optional[torch.device | str] = None,
                       mesh: Optional[Mesh] = None) -> "QueryEngine":
        """The encoder restored from ``workdir``'s latest checkpoint and the
        gallery saved at ``gallery_path``, on ``device`` (default: the first
        CUDA device), or split over ``mesh`` with the encoder on its first
        device."""
        from hashgan_tpu_torch.train.loop import Experiment

        exp = Experiment(cfg, workdir=workdir, device=device, mesh=mesh,
                         use_mesh=mesh is not None)
        exp.restore_checkpoint()
        gallery = PackedGallery.load(gallery_path, device=exp.device,
                                     mesh=mesh)
        return cls(exp.encoder, gallery, cfg=cfg)

    def encode(self, images_u8) -> torch.Tensor:
        if self._encode is None:
            raise ValueError(
                "this QueryEngine was built without an encoder (code-only "
                "serving); query with codes, or construct it with a model"
            )
        return self._encode(images_u8)

    def query_codes(self, codes, k: int = 100, mode: str = "exact",
                    with_labels: bool = False) -> QueryResult:
        self.calls += 1
        with span("query", self.calls):
            count("query.calls")
            with span("query.h2d"):
                codes = torch.as_tensor(codes, dtype=torch.float32).to(
                    self.gallery.device)
            return self._answer(codes, k, mode, with_labels)

    def query_images(self, images_u8, k: int = 100, mode: str = "exact",
                     with_labels: bool = False) -> QueryResult:
        self.calls += 1
        with span("query", self.calls):
            count("query.calls")
            with span("query.encode"):
                codes = self.encode(images_u8).to(torch.float32)
            return self._answer(codes, k, mode, with_labels)

    def _answer(self, codes: torch.Tensor, k: int, mode: str,
                with_labels: bool) -> QueryResult:
        """Float32 ``codes`` on the gallery's device -> pack -> top-k ->
        the (distances, indices) copied to the host."""
        with span("query.pack"):
            packed = pack_codes(codes)
        with span("query.topk"):
            d, i = self.gallery.topk(packed, k=k, mode=mode)
        with span("query.result"):  # waits for the device
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


class ServingPipeline:
    """Pipelined serving: each batch's encode -> pack -> scan -> top-k is
    enqueued on the device's stream by ``submit`` with no host sync, and its
    results are copied into pinned host buffers behind an event. ``drain``
    waits for the OLDEST batch's event only, so the host prepares and
    enqueues batch t+1 while the device still runs batch t. At most
    ``depth`` batches are in flight in ``map_batches``.

    The returned arrays are views of the pinned buffers. PyTorch's caching
    host allocator takes a pair back once the caller drops its results, so
    a stream whose results are consumed pins memory only while it warms
    up; every result the caller keeps holds its own pinned pair.

    As in the reference, the top-k is the grouped layout's engine for every
    k (``grouped_topk``: ``mxu_topk`` at k <= 256, ``mxu_topk_large``
    beyond), in ``mode`` ("exact" or "approx"), on the packed words (a pm8
    copy is not read). Over a sharded gallery it is the sharded engines'
    (``sharded_mxu_topk`` at k <= 256, reading the pm8 copies where the
    gallery has them, ``sharded_mxu_topk_large`` beyond): encode and pack
    on the mesh's first device, the packed queries copied to every shard,
    the merged results back on the first device. Each batch reads the
    gallery the engine holds at its ``submit``, so a swapped gallery
    (``extend``, ``remove``) serves from the next batch on. A gallery
    without a grouped layout (past ``groupmin_capacity_ok``) serves through
    ``PackedGallery.topk`` instead, and is refused here.

    On a CPU gallery the same steps run synchronously (there is no stream
    to overlap with)."""

    def __init__(self, engine: QueryEngine, k: int = 100,
                 mode: str = "exact", depth: int = 2):
        check_mode(mode)
        _grouped(engine.gallery)
        if engine._encode is None:
            raise ValueError(
                "ServingPipeline needs an encoder (QueryEngine built "
                "without one serves code queries via query_codes)"
            )
        self.engine = engine
        self.k = k
        self.mode = mode
        self.depth = depth
        self._inflight: collections.deque = collections.deque()

    def step(self, images: torch.Tensor):
        """One batch's encode -> pack -> top-k on uint8 ``images`` already on
        the gallery's device: (distances, indices) left on the device,
        enqueued on its stream with no host sync."""
        pq = pack_codes(self.engine.encode(images))
        gal = _grouped(self.engine.gallery)
        if gal.sharded:
            grouped, _, valids, bg, pm8 = gal.gallery_grouped
            if self.k <= MAX_K:
                return sharded_mxu_topk(gal.mesh, pq, grouped, bg, valids,
                                        n=gal.n, k=self.k, mode=self.mode,
                                        gallery_pm8=pm8)
            return sharded_mxu_topk_large(gal.mesh, pq, grouped, bg, valids,
                                          n=gal.n, k=self.k, mode=self.mode)
        return grouped_topk(pq, gal.gallery_grouped, gal.canon_bg,
                            valid_n=gal.n, k=self.k, mode=self.mode)

    def submit(self, images_u8: np.ndarray) -> None:
        """Enqueue a batch (asynchronous on a GPU); results queue until
        drained."""
        device = self.engine.gallery.device
        host = torch.from_numpy(np.ascontiguousarray(images_u8))
        if device.type != "cuda":
            d, i = self.step(host)
            self._inflight.append((d.numpy(), i.numpy(), None))
            return
        images = host.pin_memory().to(device, non_blocking=True)
        d, i = self.step(images)
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


def _grouped(gallery: PackedGallery) -> PackedGallery:
    if gallery.gallery_grouped is None:
        raise ValueError(
            "gallery has no grouped layout (over-capacity galleries serve "
            "through PackedGallery.topk)")
    return gallery
