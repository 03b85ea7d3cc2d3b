"""Exact Hamming top-k by brute force, and the judge of served answers.

A code's bit is set where the code is above 0. The distance of two codes
of B bits is (B - s) / 2, s the dot product of their +-1 signs, which
float32 holds exactly (TF32 off). The order is (distance asc, index asc).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def signs(codes: torch.Tensor) -> torch.Tensor:
    """+1 where a code is above 0, else -1, float32."""
    return torch.where(codes > 0, 1.0, -1.0).to(torch.float32)


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def distances(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(Q, B) and (N, B) +-1 signs -> (Q, N) int64 Hamming distances."""
    _no_tf32()
    bits = q.shape[1]
    return torch.round((bits - q @ g.t()) / 2).to(torch.int64)


def topk(q: torch.Tensor, g: torch.Tensor, k: int, block: int = 128
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of +-1 queries (Q, B) over +-1 items (N, B): (distances,
    indices), (Q, min(k, N)) int64 each, in blocks of ``block`` queries."""
    n = g.shape[0]
    kk = min(k, n)
    idx = torch.arange(n, device=g.device, dtype=torch.int64)
    ds, ix = [], []
    for lo in range(0, q.shape[0], block):
        keys = distances(q[lo:lo + block], g) * n + idx
        best = torch.topk(keys, kk, dim=1, largest=False, sorted=True).values
        ds.append(best // n)
        ix.append(best % n)
    return torch.cat(ds), torch.cat(ix)


def rows_differing(d: np.ndarray, i: np.ndarray, ref_d: np.ndarray,
                   ref_i: np.ndarray) -> int:
    """Rows of a served (Q, k) answer that differ from the reference in any
    distance or index; every row counts where the shapes differ."""
    if d.shape != ref_d.shape or i.shape != ref_i.shape:
        return int(ref_d.shape[0])
    return int(((d != ref_d) | (i != ref_i)).any(axis=1).sum())
