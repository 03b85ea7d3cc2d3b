"""Hamming-ranking evaluation on the device (port of
``hashgan_tpu/eval/map.py``).

The whole pipeline (distance scan -> exact tie-broken ranking -> AP) runs
on the codes' device, in chunks of queries, so memory holds one
(chunk, N) distance slab at a time. The gallery is transposed to the
kernel's (W, N) scan layout once per call.

Exactness: the ranking key is ``d * (N + 1) + index`` in int32, distinct for
every item, so ``torch.topk`` ranks ties toward the lower database index,
as the numpy oracle's stable argsort does, whatever its own tie order.
Relevance is ``query_labels @ db_labels.T > 0``; on the card the float32
product is exact for 0/1 labels because ``utils/device.py::set_numerics``
turns TF32 off.
"""

from __future__ import annotations

import torch

from hashgan_tpu_torch.ops.hamming import hamming_distance_t


def _chunks(packed_q: torch.Tensor, query_labels: torch.Tensor, chunk: int):
    for lo in range(0, packed_q.shape[0], chunk):
        yield packed_q[lo:lo + chunk], query_labels[lo:lo + chunk]


def device_map_at_r(packed_q: torch.Tensor, packed_g: torch.Tensor,
                    query_labels: torch.Tensor, db_labels: torch.Tensor,
                    R: int = 1000, query_chunk: int = 256) -> torch.Tensor:
    """MAP@R over packed codes: (Q, W) and (N, W) int32 words, 0/1 float
    labels. Returns a float32 scalar tensor on the codes' device."""
    q, w = packed_q.shape
    n = packed_g.shape[0]
    r_eff = min(R, n)
    stride = n + 1
    # the int32 rank key: maxd * (N+1) + N < 2**31 (N <= 16M at 128 bits)
    if (32 * w + 1) * stride + n >= 2**31:
        raise ValueError(f"gallery of {n} items at {32 * w} bits too large "
                         "for the int32 rank key")
    dev = packed_g.device
    gallery_t = packed_g.t().contiguous()
    db_t = db_labels.to(torch.float32).t()
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    ranks = torch.arange(1, r_eff + 1, dtype=torch.float32, device=dev)
    aps = []
    for pq, ql in _chunks(packed_q, query_labels.to(torch.float32),
                          min(query_chunk, q)):
        d = hamming_distance_t(pq, gallery_t)
        _, pos = torch.topk(d * stride + iota, r_eff, dim=1, largest=False,
                            sorted=True)
        rel = (ql @ db_t) > 0
        hits = torch.gather(rel, 1, pos).to(torch.float32)
        prec = hits.cumsum(dim=1) / ranks
        n_hits = hits.sum(dim=1)
        aps.append(torch.where(
            n_hits > 0, (prec * hits).sum(dim=1) / n_hits.clamp(min=1.0),
            0.0))
    return torch.cat(aps).sum() / q


def device_precision_at_radius(packed_q: torch.Tensor, packed_g: torch.Tensor,
                               query_labels: torch.Tensor,
                               db_labels: torch.Tensor, radius: int = 2,
                               query_chunk: int = 256) -> torch.Tensor:
    """Mean precision of the retrievals within Hamming radius ``radius``
    (P@H<=r); a query that retrieves nothing counts 0. Float32 scalar."""
    q = packed_q.shape[0]
    gallery_t = packed_g.t().contiguous()
    db_t = db_labels.to(torch.float32).t()
    precs = []
    for pq, ql in _chunks(packed_q, query_labels.to(torch.float32),
                          min(query_chunk, q)):
        within = hamming_distance_t(pq, gallery_t) <= radius
        rel = (ql @ db_t) > 0
        retrieved = within.sum(dim=1)
        good = (within & rel).sum(dim=1)
        precs.append(torch.where(
            retrieved > 0,
            good.to(torch.float32) / retrieved.clamp(min=1).to(torch.float32),
            0.0))
    return torch.cat(precs).sum() / q
