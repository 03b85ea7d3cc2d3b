"""Numpy Hamming-ranking evaluation oracle (a copy of
``hashgan_tpu/eval/oracle.py``; the port keeps its own, so that it never
imports the JAX package).

- relevance: query q and database item i are similar iff their label
  vectors share at least one active class (multi-label safe);
- ranking: the database sorted by Hamming distance ascending, ties broken by
  database index (a stable argsort);
- AP@R = sum_k [P@k * rel_k] / (# relevant in the top R); 0 if no relevant
  item is retrieved in the top R. MAP is the mean over queries.

The device evaluators (``eval/map.py``, ``eval/streaming.py``) are tested
against this module.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _relevance(query_labels: np.ndarray, db_labels: np.ndarray) -> np.ndarray:
    """(Q, K), (N, K) 0/1 labels -> (Q, N) bool relevance."""
    return (query_labels @ db_labels.T) > 0


def average_precision_np(
    dist: np.ndarray, rel: np.ndarray, R: int
) -> float:
    """AP@R for one query given (N,) distances and (N,) bool relevance."""
    order = np.argsort(dist, kind="stable")[:R]
    hits = rel[order].astype(np.float64)
    n_hits = hits.sum()
    if n_hits == 0:
        return 0.0
    precision_at_k = np.cumsum(hits) / np.arange(1, len(hits) + 1)
    return float((precision_at_k * hits).sum() / n_hits)


def mean_average_precision_np(
    dist: np.ndarray,
    query_labels: np.ndarray,
    db_labels: np.ndarray,
    R: int,
) -> float:
    """MAP@R over a (Q, N) distance matrix."""
    rel = _relevance(query_labels, db_labels)
    aps = [average_precision_np(dist[i], rel[i], R) for i in range(dist.shape[0])]
    return float(np.mean(aps))


def precision_at_radius_np(
    dist: np.ndarray,
    query_labels: np.ndarray,
    db_labels: np.ndarray,
    radius: int = 2,
) -> float:
    """Mean precision of items retrieved within Hamming radius.

    Queries retrieving nothing within the radius contribute precision 0
    (the common convention in the deep-hashing literature).
    """
    rel = _relevance(query_labels, db_labels)
    within = dist <= radius
    retrieved = within.sum(axis=1)
    relevant_retrieved = (within & rel).sum(axis=1)
    precision = np.where(
        retrieved > 0, relevant_retrieved / np.maximum(retrieved, 1), 0.0
    )
    return float(precision.mean())


def precision_recall_curve_np(
    dist: np.ndarray,
    query_labels: np.ndarray,
    db_labels: np.ndarray,
    n_points: int = 100,
) -> Tuple[np.ndarray, np.ndarray]:
    """Interpolated P-R curve over rank positions (mean across queries).

    Returns (precision, recall), each (n_points,), evaluated at rank cut
    points log-spaced-ish (linear here) across the database size.
    """
    q, n = dist.shape
    rel = _relevance(query_labels, db_labels)
    cuts = np.unique(np.linspace(1, n, n_points).astype(np.int64))
    precisions = np.zeros((q, len(cuts)))
    recalls = np.zeros((q, len(cuts)))
    for i in range(q):
        order = np.argsort(dist[i], kind="stable")
        hits = rel[i][order].astype(np.float64)
        ch = np.cumsum(hits)
        total_rel = max(rel[i].sum(), 1)
        precisions[i] = ch[cuts - 1] / cuts
        recalls[i] = ch[cuts - 1] / total_rel
    return precisions.mean(axis=0), recalls.mean(axis=0)
