"""Hamming-ranking evaluation over a gallery split across a mesh (port of
``hashgan_tpu/eval/sharded.py``).

- MAP@R: every shard scans its part (``sharded_hamming_topk``), the
  position-key merge gives the single-device ranked list bit for bit, and
  AP is computed from the labels of the merged list, with the arithmetic of
  ``eval/map.py::device_map_at_r``: the two give the same float.
- Distance histograms (the sufficient statistics of eval/streaming.py):
  every shard's histograms, summed on the first device (the reference's
  ``psum``). Integer sums: equal to the single-device histograms.
- P@H<=r from those histograms, reduced as ``device_precision_at_radius``
  reduces it (the reference takes ``precision_at_radius_from_hist``, whose
  mean can differ from that sum in the last bit).

Queries and their labels stay whole; only the gallery and its labels are
split. A query costs R candidates a shard (MAP) or b + 1 counters a shard
(histograms) in traffic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hashgan_tpu_torch.eval.map import QUERY_CHUNK
from hashgan_tpu_torch.eval.streaming import device_distance_histograms
from hashgan_tpu_torch.parallel.mesh import Mesh, pad_to_multiple, shard_valid
from hashgan_tpu_torch.parallel.sharded_scan import (
    _gathered,
    _shards,
    sharded_hamming_topk,
)


def shard_gallery_for_eval(
    mesh: Mesh, packed_g, db_labels,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...], int]:
    """(N, W) canonical packed codes (int32 tensor, or a uint32 / int32
    array) and (N, K) labels -> (per-shard (W, N_pad / nd) scan layouts,
    per-shard (N_pad / nd, K) float32 labels, N). Padding items are zero
    words with zero labels, never relevant and masked by ``valid_n = N``."""
    if not isinstance(packed_g, torch.Tensor):
        packed_g = torch.from_numpy(
            np.ascontiguousarray(packed_g).view(np.int32))
    db_labels = torch.as_tensor(db_labels, dtype=torch.float32).to(
        packed_g.device)
    n, w = packed_g.shape
    n_pad = pad_to_multiple(n, mesh.size)
    if n_pad != n:
        packed_g = torch.cat([packed_g, packed_g.new_zeros((n_pad - n, w))])
        db_labels = torch.cat([db_labels, db_labels.new_zeros(
            (n_pad - n,) + tuple(db_labels.shape[1:]))])
    gallery_t = tuple(g.t().contiguous() for g in
                      _shards(mesh, packed_g, 0))
    return gallery_t, tuple(_shards(mesh, db_labels, 0)), n


def sharded_map_at_r(
    mesh: Mesh, packed_q: torch.Tensor, gallery_t, query_labels: torch.Tensor,
    db_labels, R: int = 1000, valid_n: Optional[int] = None,
    slab: int = 1 << 17,
) -> torch.Tensor:
    """MAP@R over a mesh-split gallery: a float32 scalar on the first
    device, equal to ``device_map_at_r`` on the same codes. ``db_labels``
    covers the padded N (per-shard, as ``shard_gallery_for_eval`` gives
    them); ``valid_n`` is the true item count. Ranks (distance asc, index
    asc), as the numpy oracle's stable argsort; padding is never a hit."""
    gallery_t = _shards(mesh, gallery_t, 1)
    home = mesh.devices[0]
    n_pad = sum(g.shape[1] for g in gallery_t)
    valid_n = n_pad if valid_n is None else int(valid_n)
    q = packed_q.shape[0]
    max_d = 32 * packed_q.shape[1]
    r_eff = min(R, valid_n)
    labels = _gathered(mesh, _shards(mesh, db_labels, 0), dim=0)
    ql_all = query_labels.to(home, torch.float32)
    ranks = torch.arange(1, r_eff + 1, dtype=torch.float32, device=home)
    aps = []
    for lo in range(0, q, QUERY_CHUNK):
        pq = packed_q[lo:lo + QUERY_CHUNK]
        ql = ql_all[lo:lo + QUERY_CHUNK]
        d, i = sharded_hamming_topk(mesh, pq, gallery_t, k=r_eff, slab=slab,
                                    valid_n=valid_n)
        hits = _candidate_hits(labels, ql, i) & (d <= max_d) & (i < valid_n)
        hits = hits.to(torch.float32)
        # device_map_at_r's arithmetic on the same (chunk, R) shapes
        prec = hits.cumsum(dim=1) / ranks
        n_hits = hits.sum(dim=1)
        aps.append(torch.where(
            n_hits > 0, (prec * hits).sum(dim=1) / n_hits.clamp(min=1.0),
            0.0))
    return torch.cat(aps).sum() / q


def _candidate_hits(labels: torch.Tensor, ql: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """(Q, R) bool: candidate ``ids`` shares a label with its query; the
    gathered (rows, R, K) labels are taken a few queries at a time, about
    2**25 elements at once."""
    q, r = ids.shape
    safe = ids.clamp(0, labels.shape[0] - 1).long()
    rows = max(1, (1 << 25) // max(1, r * labels.shape[1]))
    return torch.cat([
        (labels[safe[a:a + rows]] * ql[a:a + rows, None, :]).sum(dim=2) > 0
        for a in range(0, q, rows)])


def sharded_distance_histograms(
    mesh: Mesh, packed_q: torch.Tensor, gallery_t, query_labels: torch.Tensor,
    db_labels, valid_n: Optional[int] = None, slab: int = 1 << 15,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, b+1) int32 (total, relevant) histograms per distance over a
    mesh-split gallery: every shard's ``device_distance_histograms`` (kernel
    4 on its device), summed on the first device. Integer sums, so equal to
    the single-device histograms of the same codes."""
    gallery_t = _shards(mesh, gallery_t, 1)
    db_labels = _shards(mesh, db_labels, 0)
    local_n = gallery_t[0].shape[1]
    valid_n = local_n * mesh.size if valid_n is None else int(valid_n)
    n_parts, r_parts = [], []
    for r, (dev, g, lab) in enumerate(zip(mesh.devices, gallery_t,
                                          db_labels)):
        n_h, r_h = device_distance_histograms(
            packed_q.to(dev), g, query_labels.to(dev), lab, slab=slab,
            valid_n=shard_valid(valid_n, r, local_n))
        n_parts.append(n_h[None])
        r_parts.append(r_h[None])
    return (_gathered(mesh, n_parts, dim=0).sum(dim=0, dtype=torch.int32),
            _gathered(mesh, r_parts, dim=0).sum(dim=0, dtype=torch.int32))


def sharded_precision_at_radius(
    mesh: Mesh, packed_q: torch.Tensor, gallery_t, query_labels: torch.Tensor,
    db_labels, radius: int = 2, valid_n: Optional[int] = None,
) -> torch.Tensor:
    """P@H<=r from the sharded histograms (exact: no tie crosses a radius):
    the mean over queries of relevant / retrieved within ``radius``, 0 for
    a query that retrieves nothing, summed and divided as
    ``device_precision_at_radius`` does."""
    n_hist, r_hist = sharded_distance_histograms(
        mesh, packed_q, gallery_t, query_labels, db_labels, valid_n=valid_n)
    retrieved = n_hist[:, :radius + 1].sum(dim=1)
    good = r_hist[:, :radius + 1].sum(dim=1)
    prec = torch.where(
        retrieved > 0,
        good.to(torch.float32) / retrieved.clamp(min=1).to(torch.float32), 0.0)
    return prec.sum() / packed_q.shape[0]
