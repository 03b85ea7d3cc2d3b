"""Sort-free evaluation from distance histograms (port of
``hashgan_tpu/eval/streaming.py``).

For b-bit codes the Hamming distances are integers in [0, b], so per-query
(total, relevant) counts at each distance are sufficient statistics for
the ranking metrics. The histogram pass streams the gallery in slabs, as
the top-k engine does, and never sorts.

- MAP: the tie-aware expected AP@R, the expectation over a uniformly random
  order inside each distance bin, in closed form with digamma sums.
- P@H<=r, the PR curve over Hamming radii and precision@top-N are exact
  (precision@top-N is the expectation within the cut bin).

Closed form per bin (n items, r relevant, N0/R0 cumulative counts before the
bin, m = positions of the bin inside the top-R cutoff):
  S1 = sum_{i=1..m} 1/(N0+i)            = psi(N0+m+1) - psi(N0+1)
  S2 = sum_{i=1..m} (i-1)/(N0+i)        = m - (N0+1) * S1
  E[sum prec@hit] += (r/n) * [(R0+1) * S1 + (r-1)/(n-1) * S2]
  E[hits]         += m * r / n
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hashgan_tpu_torch.ops.hamming import hamming_distance_t


def distance_histograms_np(dist: np.ndarray, rel: np.ndarray, max_d: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(Q, N) int distances, (Q, N) bool relevance -> (Q, max_d+1) counts."""
    q = dist.shape[0]
    n_hist = np.zeros((q, max_d + 1), dtype=np.int64)
    r_hist = np.zeros((q, max_d + 1), dtype=np.int64)
    for i in range(q):
        n_hist[i] = np.bincount(dist[i], minlength=max_d + 1)
        r_hist[i] = np.bincount(dist[i], weights=rel[i].astype(np.float64),
                                minlength=max_d + 1).astype(np.int64)
    return n_hist, r_hist


def device_distance_histograms(packed_q: torch.Tensor,
                               gallery_t: torch.Tensor,
                               query_labels: torch.Tensor,
                               db_labels: torch.Tensor, slab: int = 1 << 15,
                               valid_n: Optional[int] = None,
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, b+1) int32 histograms of (total, relevant) items per distance,
    for (Q, W) queries against a (W, N) scan-layout gallery, in slabs of
    ``slab`` items. Items with index >= ``valid_n`` (default N) are padding
    and counted nowhere; ``db_labels`` rows may stop at N (the reference
    pads them with zeros; a padded item is never relevant).

    Each slab's distances go into one ``scatter_add_`` on the flat bins
    ``query * (b+1) + d``; padding lands in a spare bin that is dropped."""
    q, w = packed_q.shape
    n = gallery_t.shape[1]
    valid_n = n if valid_n is None else min(int(valid_n), n)
    bins = 32 * w + 1
    dev = gallery_t.device
    ql = query_labels.to(torch.float32)
    dl = db_labels.to(torch.float32)
    spare = q * bins
    n_flat = torch.zeros(spare + 1, dtype=torch.int32, device=dev)
    r_flat = torch.zeros(spare + 1, dtype=torch.int32, device=dev)
    row = torch.arange(q, dtype=torch.int64, device=dev)[:, None] * bins
    for lo in range(0, valid_n, slab):
        hi = min(lo + slab, valid_n)
        d = hamming_distance_t(packed_q, gallery_t[:, lo:hi])
        flat = row + d                                        # (Q, slab) int64
        rel = (ql @ dl[lo:hi].t()) > 0
        ones = torch.ones_like(d)
        n_flat.scatter_add_(0, flat.view(-1), ones.view(-1))
        r_flat.scatter_add_(0, torch.where(rel, flat, spare).view(-1),
                            ones.view(-1))
    return n_flat[:spare].view(q, bins), r_flat[:spare].view(q, bins)


def tie_aware_map_np(n_hist: np.ndarray, r_hist: np.ndarray, R: int) -> float:
    """Position-loop numpy oracle of the tie-aware expected MAP@R."""
    q = n_hist.shape[0]
    aps = []
    for qi in range(q):
        n0 = r0 = 0
        exp_prec_sum = 0.0
        exp_hits = 0.0
        for v in range(n_hist.shape[1]):
            n, r = int(n_hist[qi, v]), int(r_hist[qi, v])
            if n == 0:
                continue
            m = min(n, max(R - n0, 0))
            if m > 0:
                p_rel = r / n
                c = (r - 1) / (n - 1) if n > 1 else 0.0
                for i in range(1, m + 1):
                    exp_prec_sum += p_rel * (r0 + 1 + (i - 1) * c) / (n0 + i)
                exp_hits += m * p_rel
            n0 += n
            r0 += r
        aps.append(exp_prec_sum / exp_hits if exp_hits > 0 else 0.0)
    return float(np.mean(aps))


def tie_aware_map(n_hist: torch.Tensor, r_hist: torch.Tensor,
                  R: int) -> torch.Tensor:
    """Closed-form (digamma) tie-aware expected MAP@R in float32, as the
    reference computes it. (Q, B+1) histograms -> scalar tensor."""
    digamma = torch.special.digamma
    n = n_hist.to(torch.float32)
    r = r_hist.to(torch.float32)
    n0 = torch.cumsum(n, dim=1) - n          # items before the bin
    r0 = torch.cumsum(r, dim=1) - r          # relevant items before the bin
    m = torch.minimum((float(R) - n0).clamp(min=0.0), n)  # inside the cutoff
    s1 = digamma(n0 + m + 1.0) - digamma(n0 + 1.0)
    s2 = m - (n0 + 1.0) * s1
    p_rel = torch.where(n > 0, r / n.clamp(min=1.0), 0.0)
    c = torch.where(n > 1, (r - 1.0) / (n - 1.0).clamp(min=1.0), 0.0)
    prec_sum = (p_rel * ((r0 + 1.0) * s1 + c * s2)).sum(dim=1)
    hits = (m * p_rel).sum(dim=1)
    ap = torch.where(hits > 0, prec_sum / hits.clamp(min=1e-12), 0.0)
    return ap.mean()


def precision_at_radius_from_hist(n_hist: torch.Tensor, r_hist: torch.Tensor,
                                  radius: int) -> torch.Tensor:
    n_cum = n_hist[:, :radius + 1].sum(dim=1).to(torch.float32)
    r_cum = r_hist[:, :radius + 1].sum(dim=1).to(torch.float32)
    return torch.where(n_cum > 0, r_cum / n_cum.clamp(min=1.0), 0.0).mean()


def pr_curve_from_hist(n_hist, r_hist) -> Tuple[np.ndarray, np.ndarray]:
    """Exact PR curve over Hamming radii (mean across queries), float64
    numpy, from histograms given as tensors or arrays."""
    n_cum = np.cumsum(np.asarray(n_hist, dtype=np.float64), axis=1)
    r_cum = np.cumsum(np.asarray(r_hist, dtype=np.float64), axis=1)
    total_rel = np.maximum(r_cum[:, -1:], 1.0)
    precision = np.where(n_cum > 0, r_cum / np.maximum(n_cum, 1.0), 0.0)
    recall = r_cum / total_rel
    return precision.mean(axis=0), recall.mean(axis=0)


def precision_at_topn_from_hist(n_hist, r_hist, topns) -> np.ndarray:
    """Expected precision@N over the Hamming ranking for each cutoff N:
    within a distance bin the expected number of relevant items among its
    first m ranked positions is m * r/n, and precision divides by the
    number returned, min(N, gallery size). Mean across queries, float64."""
    n = np.asarray(n_hist, dtype=np.float64)
    r = np.asarray(r_hist, dtype=np.float64)
    n0 = np.cumsum(n, axis=1) - n                        # (Q, B+1)
    p_rel = np.where(n > 0, r / np.maximum(n, 1.0), 0.0)
    total = n.sum(axis=1, keepdims=True)                 # (Q, 1)
    topns = np.asarray(topns, dtype=np.int64)
    m = np.clip(topns[None, None, :] - n0[:, :, None], 0.0, n[:, :, None])
    exp_rel = (m * p_rel[:, :, None]).sum(axis=1)        # (Q, T)
    returned = np.minimum(topns[None, :], np.maximum(total, 1.0))
    return (exp_rel / returned).mean(axis=0)


def precision_at_topn_np(dist: np.ndarray, rel: np.ndarray,
                         topns: np.ndarray) -> np.ndarray:
    """Position-loop oracle of ``precision_at_topn_from_hist``."""
    q, n_items = dist.shape
    topns = np.asarray(topns, dtype=np.int64)
    out = np.zeros((q, len(topns)))
    for qi in range(q):
        order = np.argsort(dist[qi], kind="stable")
        d_sorted = dist[qi][order]
        rel_sorted = rel[qi][order].astype(np.float64)
        exp_pos = np.empty(n_items)  # relevance spread evenly in a tie bin
        lo = 0
        while lo < n_items:
            hi = lo
            while hi < n_items and d_sorted[hi] == d_sorted[lo]:
                hi += 1
            exp_pos[lo:hi] = rel_sorted[lo:hi].mean()
            lo = hi
        cum = np.cumsum(exp_pos)
        for ti, N in enumerate(topns):
            k = min(int(N), n_items)
            out[qi, ti] = cum[k - 1] / min(int(N), n_items) if k > 0 else 0.0
    return out.mean(axis=0)
