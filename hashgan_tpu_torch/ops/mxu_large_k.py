"""Exact top-k at large k (up to thousands): subgroup-min scan and
winner-subgroup rescan (port of ``hashgan_tpu/ops/mxu_large_k.py``).

The k <= 256 engine (ops/mxu_scan.py) rescans the k winning columns, k*L
items a query; at the reference protocol's MAP@5000 that is 640k items.
This engine keeps the scan but selects subgroups of ``sigma`` (16)
consecutive items of a column:

1. Scan (kernel ``csrc/subgroupmin_scan.cu``): for every (query, subgroup)
   the DISTINCT int32 key of its smallest item, d*stride + s*C + c, with
   all-padding subgroups at the distinct (bits + 1)*stride + s*C + c above
   every valid key. The TPU kernel emits float32 minima d*L + s (+2**22) and
   its caller decodes them (``_subgroup_full_keys``); the port's kernel
   emits the decoded keys, and its plain twin runs both steps.
2. Winner subgroups: the m = min(k, R*C) smallest keys. Any top-k item lives
   in a subgroup whose minimum is <= the k-th best key, and at most k
   subgroups can have such a minimum (their minima are k distinct item
   keys), so rescanning them is exact. ``select``: ``sortdecode`` (the
   default: one sort of the keys, the winners decoded from the keys
   themselves), ``twolevel`` (the rank-bound top-k reduction) or ``radix``
   (a counting select, then a compaction by ``scatter`` or
   ``searchsorted``). All three are exact over distinct keys and give the
   same answer; only their cost differs.
3. Rescan (kernel ``csrc/fused_rescan.cu`` with sigma = 16): the exact keys
   of the m*sigma items, read as sigma*W-word rows of the same group-major
   copy the column rescan reads.
4. The k smallest rescan keys, decoded.

``mode="approx"``: the m best subgroup minima without the rescan. The
reference selects them with ``lax.approx_min_k``; the port takes the exact
m best over the distinct keys (ties of (d, s) to the lower column), so its
recall is the subgroup-collision term alone and any ``recall_target`` is
met (it stays in the signature for parity). The distances equal the
reference's on the CPU, where ``approx_min_k`` returns exact minima.

Total order: (distance asc, database index asc).
"""

from __future__ import annotations

from typing import Tuple

import torch

from hashgan_tpu_torch.ops import _build
from hashgan_tpu_torch.ops.mxu_scan import (
    GROUPED_MAX_QUERIES,
    PAD_PENALTY,
    _twolevel_topk_min,
    check_mode,
    chunked_distances,
    decode_keys,
    fused_rescan_keys,
    local_keys,
    mxu_topk,
    pad_sentinels,
)

MAX_K = 256  # deepest k of the winner-column engine (mxu_topk)
SIGMA = 16
SELECTS = ("sortdecode", "twolevel", "radix")
COMPACTS = ("scatter", "searchsorted")


def _subgroup_full_keys(min_sub: torch.Tensor, L: int, c: int, stride: int,
                        bits: int) -> torch.Tensor:
    """(Q, R, C) subgroup-min local keys d*L + s (+2**22 on all-padding
    subgroups; float32 or int32) -> (Q, R*C) DISTINCT int32 composite keys
    d*stride + s*C + col, and (bits + 1)*stride + s*C + col for padding.
    The reference takes s = key % L before removing the 2**22, which holds
    only where L divides 2**22; s is taken after it here, so the padding
    keys name their own row at every L (L = 300: the reference's are 4 rows
    off) and equal the reference's wherever L is a power of two."""
    q, r, _ = min_sub.shape
    key = min_sub.reshape(q, r * c).to(torch.int64)
    is_pad = key >= PAD_PENALTY
    key = key - torch.where(is_pad, PAD_PENALTY, 0)
    s, d = key % L, key // L
    cols = torch.arange(r * c, dtype=torch.int64, device=key.device) % c
    idx = s * c + cols
    return torch.where(is_pad, (bits + 1) * stride + idx,
                       d * stride + idx).to(torch.int32)


def subgroupmin_scan_keys_torch(packed_q: torch.Tensor,
                                gallery_g: torch.Tensor, valid_n: int,
                                stride: int, sigma: int) -> torch.Tensor:
    """Plain version of kernel 5: the reference's subgroup minima of the
    local keys d*L + s (+2**22), then ``_subgroup_full_keys``."""
    q = packed_q.shape[0]
    w, L, c = gallery_g.shape
    r = L // sigma
    out = torch.empty((q, r * c), dtype=torch.int32, device=gallery_g.device)
    for lo, hi, d in chunked_distances(packed_q, gallery_g):
        mins = local_keys(d, valid_n).view(hi - lo, r, sigma, c).amin(dim=2)
        out[lo:hi] = _subgroup_full_keys(mins, L, c, stride, 32 * w)
    return out


def mxu_subgroupmin_scan(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                         valid_n: int, stride: int,
                         sigma: int = SIGMA) -> torch.Tensor:
    """(Q, W) packed queries x (W, L, C) grouped gallery -> (Q, R*C) int32
    distinct subgroup keys (R = L / sigma, subgroup u = j*C + c), i.e.
    ``_subgroup_full_keys(mxu_subgroupmin_scan(...))`` of the reference.
    CUDA tensors launch ``csrc/subgroupmin_scan.cu``; CPU tensors run
    ``subgroupmin_scan_keys_torch``."""
    w, L, c = gallery_g.shape
    _build.check_words(packed_q, w)
    if L % sigma:
        raise ValueError(f"L={L} is not a multiple of sigma={sigma}")
    if gallery_g.device.type == "cpu":
        return subgroupmin_scan_keys_torch(packed_q, gallery_g, valid_n,
                                           stride, sigma)
    if L > 65536:
        raise ValueError(f"the scan kernel takes at most 65536 groups, got {L}")
    q = packed_q.shape[0]
    _build.check_queries(q, GROUPED_MAX_QUERIES)
    _build.require_cuda_tensor(packed_q, "packed_q", torch.int32, 2)
    _build.require_cuda_tensor(gallery_g, "gallery_g", torch.int32, 3)
    out = torch.empty((q, (L // sigma) * c), dtype=torch.int32,
                      device=gallery_g.device)
    if out.numel():
        _build.KERNELS.launch(
            "subgroupmin_scan", gallery_g.device, packed_q.data_ptr(),
            gallery_g.data_ptr(), out.data_ptr(), q, w, L, c, sigma,
            int(valid_n), stride, 32 * w + 1)
    return out


def count_select_threshold(keys: torch.Tensor, kk: int, hi: int,
                           pivots: int = 16) -> torch.Tensor:
    """Exact kk-th smallest of each row of (Q, M) DISTINCT non-negative
    keys (kk <= M, all keys <= hi), by multi-pivot counting: each round cuts
    the live interval into ``pivots`` buckets and counts the keys <= each
    bucket's upper edge, keeping the first bucket whose count reaches kk.
    The (Q, M, P) compare that XLA fuses is taken over column chunks here,
    so it stays near 2**24 elements. Returns (Q,) int32 thresholds tau with
    exactly kk keys <= tau per row."""
    q, m = keys.shape
    if kk > m:
        raise ValueError(f"kk={kk} > {m} keys")
    lo = torch.zeros((q,), dtype=torch.int64, device=keys.device)
    steps = torch.arange(1, pivots + 1, dtype=torch.int64, device=keys.device)
    chunk = max(1, (1 << 24) // max(1, q * pivots))
    width = hi + 1
    while width > 1:
        wb = -(-width // pivots)                     # bucket width
        edges = lo[:, None] + steps[None, :] * wb - 1  # (Q, P) inclusive
        cnt = torch.zeros((q, pivots), dtype=torch.int64, device=keys.device)
        for a in range(0, m, chunk):
            cnt += (keys[:, a:a + chunk, None] <= edges[:, None, :]).sum(dim=1)
        lo = lo + torch.argmax((cnt >= kk).to(torch.int32), dim=1) * wb
        width = wb
    return lo.to(torch.int32)


def _compact_masked(values: torch.Tensor, mask: torch.Tensor, kk: int,
                    method: str = "scatter") -> torch.Tensor:
    """Dense-packs the exactly-kk masked entries of each (Q, M) row into
    (Q, kk), keeping their order. ``scatter``: cumsum positions and one
    scatter into a (Q, kk + M) buffer whose tail takes the non-survivors
    (``torch.scatter_`` has no ``mode="drop"``), then a slice.
    ``searchsorted``: a binary search of the cumsum for each output slot,
    then a gather."""
    if method not in COMPACTS:
        raise ValueError(f"compact must be one of {COMPACTS}, got {method!r}")
    q, m = values.shape
    cs = torch.cumsum(mask.to(torch.int64), dim=1)
    if method == "searchsorted":
        targets = torch.arange(1, kk + 1, dtype=torch.int64,
                               device=values.device).expand(q, kk).contiguous()
        pos = torch.searchsorted(cs, targets, side="left")
        return torch.gather(values, 1, pos)
    tail = kk + torch.arange(m, dtype=torch.int64, device=values.device)
    slots = torch.where(mask, cs - 1, tail)
    out = values.new_zeros((q, kk + m))
    return out.scatter_(1, slots, values)[:, :kk]


def mxu_topk_large(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                   canon_bg_flat: torch.Tensor, valid_n: int, k: int = 1000,
                   sigma: int = SIGMA, mode: str = "exact",
                   select: str = "sortdecode", compact: str = "scatter",
                   recall_target: float = 0.95,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k for large k: the reference's ``mxu_topk_large``. Same contract
    as ``mxu_topk``: (distances (Q, kk), indices (Q, kk)) int32 in oracle
    rank order, kk = min(k, L*C); entries with index >= valid_n are padding
    sentinels (d = bits + 1, i = L*C). No fallback path."""
    check_mode(mode)
    if select not in SELECTS:
        raise ValueError(f"select must be one of {SELECTS}, got {select!r}")
    q, w = packed_q.shape
    _, L, c = gallery_g.shape
    n_total = L * c
    bits = 32 * w
    stride = n_total + 1
    sigma = min(sigma, L)  # small (test) layouts: degrade toward columns
    if L % sigma:
        raise ValueError(f"L={L} is not a multiple of sigma={sigma}")
    r_sub = L // sigma
    if (bits + 2) * stride + n_total >= 2**31:
        raise ValueError(
            f"composite keys overflow int32 at {n_total} layout items x "
            f"{bits} bits; use the slabbed engine (ops/slab_scan.py)")

    full = mxu_subgroupmin_scan(packed_q, gallery_g, valid_n, stride, sigma)
    kk = min(k, n_total)
    m1 = r_sub * c
    m_win = min(kk, m1)

    if mode == "approx":
        top, _ = torch.topk(full, m_win, dim=1, largest=False)
        d, i = decode_keys(top, stride, bits, n_total)
        return pad_sentinels(d, i, kk, bits, n_total)

    hi = (bits + 1) * stride + n_total
    if select == "twolevel":
        _, us = _twolevel_topk_min(full, m_win)
    elif select == "sortdecode":
        # Keys are distinct and self-identifying (key % stride is the item
        # index s*C + col), so the winners decode from the sorted keys.
        top1 = torch.sort(full, dim=1).values[:, :m_win]
        i1 = top1 % stride
        us = (i1 // c // sigma) * c + i1 % c  # subgroup j*C + col
    else:
        tau_w = count_select_threshold(full, m_win, hi)
        iota = torch.arange(m1, dtype=torch.int32, device=full.device)
        us = _compact_masked(iota.expand(q, m1), full <= tau_w[:, None],
                             m_win, method=compact)
    # winner subgroup u = j*C + col -> rescan row col*R + j
    rows = (us % c) * r_sub + us // c
    rescan = fused_rescan_keys(packed_q, canon_bg_flat, rows, stride, valid_n,
                               sigma=sigma, pad_d=bits + 1)
    if select == "twolevel":
        final, _ = _twolevel_topk_min(rescan, kk)
    elif select == "sortdecode":
        final = torch.sort(rescan, dim=1).values[:, :kk]
    else:
        tau_f = count_select_threshold(rescan, kk, hi)
        final = torch.sort(_compact_masked(rescan, rescan <= tau_f[:, None],
                                           kk, method=compact), dim=1).values
    return decode_keys(final, stride, bits, n_total)


def grouped_topk(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                 canon_bg_flat: torch.Tensor, valid_n: int, k: int,
                 mode: str = "exact", gallery_pm8: torch.Tensor | None = None,
                 column_approx: bool = True,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grouped layout's engine for ``k``: ``mxu_topk`` at k <= MAX_K,
    ``mxu_topk_large`` beyond. ``column_approx=False`` keeps approx queries
    on the subgroup engine at every k, as the reference's slab engine does.
    ``gallery_pm8`` (the +-1 copy) is read by the column engine only."""
    if k <= MAX_K and (mode == "exact" or column_approx):
        return mxu_topk(packed_q, gallery_g, canon_bg_flat, valid_n=valid_n,
                        k=k, mode=mode, gallery_pm8=gallery_pm8)
    return mxu_topk_large(packed_q, gallery_g, canon_bg_flat, valid_n=valid_n,
                          k=k, mode=mode)
