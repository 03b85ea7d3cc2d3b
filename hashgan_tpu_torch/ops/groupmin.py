"""Grouped scan layout, and the min2/repair engine (port of
``hashgan_tpu/ops/groupmin.py``).

The gallery lives in a grouped scan layout (W, L, C): item ``n = s * C + c``
is word-sliced at ``[w, s, c]``, so a column c holds the group of L items
the scans take one minimum over.

The repair engine (``groupmin_topk``, selected by an explicit ``repair``):

1. Scan (kernel ``csrc/groupmin_min2.cu``): per (query, column) the smallest
   and the second-smallest composite key ``d * stride + idx``
   (+ PAD_BASE on padding items).
2. The k smallest column minima are the preliminary answer. It can only
   miss a true top-k item if a column hides two or more of them, and any
   such column has min2 <= the k-th preliminary key.
3. The ``repair`` columns with the smallest min2 (a superset of those
   flagged columns whenever there are at most ``repair`` of them) are
   rescanned exactly (kernel ``csrc/fused_rescan.cu``) and merged in.
4. A query with more flagged columns than ``repair`` comes back with
   ``needs_fallback``; the gallery recomputes it with the sort engine.
   ``repair >= k`` makes that unreachable.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hashgan_tpu_torch.ops import _build

INT32_MAX = 2**31 - 1

# Padding addend base of the min2 engine: padding items get keys >= PAD_BASE,
# above every valid key. It also sets the capacity limit below, so the port
# puts exactly the galleries the reference does on the grouped layout.
PAD_BASE = 1_000_000_000

MAX_QUERIES = 65535 * 128  # kernel 7's grid: 128 or 256 queries a row


def layout_columns(n: int, groups: int = 128, col_multiple: int = 256) -> int:
    """Column count C of the grouped layout for n items (a multiple of
    ``col_multiple``, so ``L * C >= n``)."""
    return -(-n // (groups * col_multiple)) * col_multiple


def pad_to_layout(packed: torch.Tensor, groups: int = 128,
                  col_multiple: int = 256) -> torch.Tensor:
    """(N, W) canonical words -> (L*C, W) with all-zero padding items."""
    n, w = packed.shape
    n_pad = groups * layout_columns(n, groups, col_multiple)
    if n_pad == n:
        return packed
    return torch.cat([packed, packed.new_zeros((n_pad - n, w))], dim=0)


def to_grouped_layout(packed: torch.Tensor, groups: int = 128,
                      col_multiple: int = 256) -> torch.Tensor:
    """(N, W) canonical packed codes -> (W, L, C) grouped scan layout.

    Padding items occupy the tail indices (>= N); the scan masks them by
    ``valid_n``. Runs on the tensor's own device."""
    w = packed.shape[1]
    c = layout_columns(packed.shape[0], groups, col_multiple)
    cube = pad_to_layout(packed, groups, col_multiple).view(groups, c, w)
    return cube.permute(2, 0, 1).contiguous()


def groupmin_capacity_ok(
    n_total: int, words: int, groups: int = 128, col_multiple: int = 256,
    pad_base: int = PAD_BASE,
) -> bool:
    """Whether an n-item gallery fits the grouped engines' int32 key space
    (~7.7M items at 128 bits, ~15M at 64, ~30M at 32). ``n_total`` is padded
    to the layout unit before the check. Past it the gallery takes the
    slabbed layout (ops/slab_scan.py)."""
    unit = groups * col_multiple
    n_pad = -(-max(n_total, 1) // unit) * unit
    stride = n_pad + 1
    return (32 * words + 1) * stride + n_pad < pad_base


def build_addend(L: int, cols: int, valid_n: int, device=None) -> torch.Tensor:
    """(L, cols) int32 key addend of the min2 engine: idx for valid items,
    PAD_BASE + idx for padding."""
    idx = (torch.arange(L, dtype=torch.int32, device=device)[:, None] * cols
           + torch.arange(cols, dtype=torch.int32, device=device)[None, :])
    return torch.where(idx < valid_n, idx, idx + PAD_BASE)


def groupmin_scan_torch(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                        valid_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 7: the reference's key d*stride + addend,
    its column minimum, and the minimum after masking that one."""
    from hashgan_tpu_torch.ops.mxu_scan import chunked_distances

    q = packed_q.shape[0]
    _, L, c = gallery_g.shape
    stride = L * c + 1
    addend = build_addend(L, c, valid_n, gallery_g.device)
    min1 = torch.empty((q, c), dtype=torch.int32, device=gallery_g.device)
    min2 = torch.empty_like(min1)
    for lo, hi, d in chunked_distances(packed_q, gallery_g):
        key = d * stride + addend
        m1 = key.amin(dim=1)
        min1[lo:hi] = m1
        min2[lo:hi] = torch.where(key == m1[:, None, :], INT32_MAX,
                                  key).amin(dim=1)
    return min1, min2


def groupmin_scan(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                  valid_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, W) x (W, L, C) -> (min_keys, min2_keys), each (Q, C) int32.
    CUDA tensors launch ``csrc/groupmin_min2.cu``; CPU tensors run
    ``groupmin_scan_torch``."""
    q, w = packed_q.shape
    _, L, c = gallery_g.shape
    _build.check_words(packed_q, w)
    stride = L * c + 1
    if (32 * w + 1) * stride + L * c >= PAD_BASE:
        raise ValueError(
            "grouped engine key overflow: build_gallery_from_packed_device "
            "puts such a gallery on the slabbed layout (groupmin_capacity_ok)")
    if gallery_g.device.type == "cpu":
        return groupmin_scan_torch(packed_q, gallery_g, valid_n)
    if L > 65536:
        raise ValueError(f"the scan kernel takes at most 65536 groups, got {L}")
    _build.check_queries(q, MAX_QUERIES)
    _build.require_cuda_tensor(packed_q, "packed_q", torch.int32, 2)
    _build.require_cuda_tensor(gallery_g, "gallery_g", torch.int32, 3)
    min1 = torch.empty((q, c), dtype=torch.int32, device=gallery_g.device)
    min2 = torch.empty_like(min1)
    if min1.numel():
        _build.KERNELS.launch(
            "groupmin_min2", gallery_g.device, packed_q.data_ptr(),
            gallery_g.data_ptr(), min1.data_ptr(), min2.data_ptr(), q, w, L,
            c, int(valid_n), stride)
    return min1, min2


def groupmin_topk(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                  canon_bg_flat: torch.Tensor, valid_n: int, k: int = 100,
                  repair: int = 8, exact: bool = True,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group-min top-k (the reference's ``groupmin_topk``): (distances
    (Q, kk), indices (Q, kk), needs_fallback (Q,) bool), kk = min(k, L*C);
    padding entries are sentinels (bits + 1, L*C).

    The reference rescans from the canonical (L*C, W) copy; its rescan keys
    are exactly the column rescan's, so the port reads the group-major copy
    ``canon_bg_flat`` (C, L*W) through ``fused_rescan_keys``. The columns
    already rescanned are found with a (Q, C) mask, not the reference's
    (Q, kk, repair) compare, which would not fit at k = repair = 5000."""
    from hashgan_tpu_torch.ops.mxu_scan import decode_keys, fused_rescan_keys

    q, w = packed_q.shape
    _, L, c = gallery_g.shape
    n_total = L * c
    stride = n_total + 1
    bits = 32 * w
    kk = min(k, n_total)
    if kk > c:  # the reference's lax.top_k over the column minima refuses it
        raise ValueError(f"k={kk} exceeds the {c} columns of the layout")
    min1, min2 = groupmin_scan(packed_q, gallery_g, valid_n)
    prelim, _ = torch.topk(min1, kk, dim=1, largest=False)   # distinct keys
    if not exact:
        d, i = decode_keys(prelim, stride, bits, n_total)
        return d, i, torch.zeros((q,), dtype=torch.bool, device=d.device)

    kth = prelim[:, -1:]
    n_flagged = (min2 <= kth).sum(dim=1)
    repair = min(repair, c)
    needs_fallback = n_flagged > repair
    _, cand_cols = torch.topk(min2, repair, dim=1, largest=False)
    rescan = fused_rescan_keys(packed_q, canon_bg_flat, cand_cols, stride,
                               valid_n)
    # Drop the preliminary entries of rescanned columns: they come back in
    # the rescan, and duplicates would displace real winners.
    rescanned = torch.zeros((q, c), dtype=torch.bool, device=min1.device)
    rescanned.scatter_(1, cand_cols, True)
    dup = torch.gather(rescanned, 1, ((prelim % stride) % c).long())
    prelim = torch.where(dup, INT32_MAX, prelim)
    final, _ = torch.topk(torch.cat([prelim, rescan], dim=1), kk, dim=1,
                          largest=False)
    d, i = decode_keys(final, stride, bits, n_total)
    return d, i, needs_fallback
