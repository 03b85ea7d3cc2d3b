"""Exact Hamming top-k: full-key scan + winner-column rescan.

Port of the exact branch of ``hashgan_tpu/ops/mxu_scan.py::mxu_topk``. The
algorithm is the reference's; only the distance arithmetic changes with the
hardware (XOR + popcount on the packed words instead of a +-1 matmul).

1. Scan (kernel ``csrc/mxu_fullkey_scan.cu``): for every (query, column)
   of the grouped (W, L, C) gallery, the smallest composite key
   ``d * stride + idx`` over the column's L items (``idx = s * C + c``,
   ``stride = L * C + 1``). Keys are DISTINCT (the index is unique), so
   every selection below is tie-free and ``torch.topk``'s unspecified tie
   order cannot change a result. A reshape-min gives subgroup minima.
2. Winner columns: the m = min(k, C) columns with the smallest keys. The
   k-th smallest column minimum bounds the k-th best key overall, so no
   other column can hold a top-k item.
3. Rescan (kernel ``csrc/fused_rescan.cu``): exact keys of every item of the
   winner columns, read from the group-major copy (C, L*W).
4. The k smallest rescan keys, decoded to (distance, index); padding
   sentinels decode to ``d = bits + 1`` and ``i = L * C``.

Total order: (distance asc, database index asc) — the numpy oracle's.
Each kernel has its plain PyTorch twin in this module; the wrappers use the
plain version only for CPU tensors and launch the kernel (or raise) for
CUDA tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hashgan_tpu_torch.ops import _build
from hashgan_tpu_torch.ops.groupmin import (
    INT32_MAX,
    layout_columns,
    pad_to_layout,
)
from hashgan_tpu_torch.ops.pack import popcount32

MAX_WORDS = 8  # the kernels are instantiated for 1..8 words (<= 256 bits)
SUB_G = 16     # columns per subgroup minimum (reference: sub_g=16)


def to_group_major(packed: torch.Tensor, groups: int = 128,
                   col_multiple: int = 256) -> torch.Tensor:
    """(N, W) canonical packed codes -> (C, L, W) group-major layout: column
    c's L items are one contiguous L*W-word row (2 KB at 128 bits), the row
    the rescan reads. Same item mapping as ``to_grouped_layout``: item
    n = s*C + c lives at [c, s]. Runs on the tensor's own device."""
    w = packed.shape[1]
    c = layout_columns(packed.shape[0], groups, col_multiple)
    cube = pad_to_layout(packed, groups, col_multiple).view(groups, c, w)
    return cube.permute(1, 0, 2).contiguous()


def unpack_to_pm1(packed: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(Q, W) int32 words -> (Q, 32W) +-1 values (bit i of word w =
    element 32w + i)."""
    q, w = packed.shape
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return (bits * 2 - 1).to(dtype).reshape(q, w * 32)


def check_key_space(bits: int, n_total: int) -> int:
    """The composite keys' int32 bound (reference ``mxu_scan.py:690``);
    returns ``stride``."""
    stride = n_total + 1
    if (bits + 1) * stride + n_total >= 2**31:
        raise ValueError(
            f"composite keys overflow int32 at {n_total} layout items x "
            f"{bits} bits; galleries past groupmin_capacity_ok need the "
            "slabbed engine, which is not ported yet (ROADMAP.md)"
        )
    return stride


def _check_kernel_args(packed_q: torch.Tensor, words: int) -> None:
    if not 1 <= words <= MAX_WORDS:
        raise ValueError(f"the kernels take 1..{MAX_WORDS} words, got {words}")
    if packed_q.shape[1] != words:
        raise ValueError(
            f"queries have {packed_q.shape[1]} words, gallery {words}")


# --------------------------------------------------------------------------
# 1. Full-key scan
# --------------------------------------------------------------------------

def fullkey_scan_keys_torch(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                            valid_n: int, stride: int) -> torch.Tensor:
    """Plain version of the scan kernel: (Q, W) x (W, L, C) -> (Q, C) int32
    full composite keys. Chunked over queries so the (chunk, W, L, C)
    XOR intermediate stays near 64 MB of int32."""
    q = packed_q.shape[0]
    w, L, c = gallery_g.shape
    dev = gallery_g.device
    idx = (torch.arange(L, dtype=torch.int32, device=dev)[:, None] * c
           + torch.arange(c, dtype=torch.int32, device=dev)[None, :])
    valid = idx < valid_n
    full = torch.empty((q, c), dtype=torch.int32, device=dev)
    chunk = max(1, (1 << 24) // max(1, w * L * c))
    for lo in range(0, q, chunk):
        hi = min(lo + chunk, q)
        x = gallery_g[None] ^ packed_q[lo:hi, :, None, None]   # (ch, W, L, C)
        d = popcount32(x).sum(dim=1, dtype=torch.int32)        # (ch, L, C)
        key = torch.where(valid, d * stride + idx, INT32_MAX)
        full[lo:hi] = key.amin(dim=1)
    return full


def fullkey_scan_keys(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                      valid_n: int, stride: int) -> torch.Tensor:
    """(Q, W) packed queries x (W, L, C) grouped gallery -> (Q, C) int32
    full composite keys. CUDA tensors launch ``csrc/mxu_fullkey_scan.cu``;
    CPU tensors run ``fullkey_scan_keys_torch``."""
    w, L, c = gallery_g.shape
    _check_kernel_args(packed_q, w)
    if gallery_g.device.type == "cpu":
        return fullkey_scan_keys_torch(packed_q, gallery_g, valid_n, stride)
    if L > 65536:
        raise ValueError(f"the scan kernel takes at most 65536 groups, got {L}")
    _build.require_cuda_tensor(packed_q, "packed_q", torch.int32, 2)
    _build.require_cuda_tensor(gallery_g, "gallery_g", torch.int32, 3)
    q = packed_q.shape[0]
    full = torch.empty((q, c), dtype=torch.int32, device=gallery_g.device)
    if full.numel():
        _build.KERNELS.launch(
            "mxu_fullkey_scan", gallery_g.device, packed_q.data_ptr(),
            gallery_g.data_ptr(), full.data_ptr(), q, w, L, c, int(valid_n),
            stride)
    return full


def mxu_fullkey_scan(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                     valid_n: int, stride: int, sub_g: int = SUB_G,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, W) packed queries x (W, L, C) grouped gallery -> ((Q, C) int32
    full composite keys, (Q, C // sub_g) int32 subgroup minima).

    Differs from the reference's signature: it takes the PACKED queries and
    ``valid_n`` where the TPU kernel takes +-1 bf16 queries and an f32 key
    base (the TPU computes d = (B - q.g) / 2 on its matrix unit; the keys
    are identical), and C comes from the gallery's shape. The subgroup
    minima are a reshape-min after the scan, as in the reference
    (``mxu_scan.py:419``)."""
    q = packed_q.shape[0]
    c = gallery_g.shape[2]
    if c % sub_g:
        raise ValueError(f"column count {c} is not a multiple of sub_g={sub_g}")
    full = fullkey_scan_keys(packed_q, gallery_g, valid_n, stride)
    sub = full.view(q, c // sub_g, sub_g).amin(dim=2)
    return full, sub


# --------------------------------------------------------------------------
# 3. Winner-column rescan
# --------------------------------------------------------------------------

def _rescan_winner_columns(packed_q: torch.Tensor, canon_bg_flat: torch.Tensor,
                           cols: torch.Tensor, stride: int,
                           valid_n: int) -> torch.Tensor:
    """Plain version of the rescan kernel: exact keys of every item of the
    winner columns. canon_bg_flat (C, L*W); cols (Q, M) column ids in
    [0, C). Returns (Q, M*L) int32 keys, INT32_MAX where idx >= valid_n."""
    q, w = packed_q.shape
    c = canon_bg_flat.shape[0]
    L = canon_bg_flat.shape[1] // w
    m = cols.shape[1]
    rows = canon_bg_flat[cols.long()].view(q, m, L, w)          # (Q, M, L, W)
    d = popcount32(rows ^ packed_q[:, None, None, :]).sum(
        dim=-1, dtype=torch.int32)                               # (Q, M, L)
    s_ids = torch.arange(L, dtype=torch.int32, device=cols.device)
    idx = s_ids[None, None, :] * c + cols[:, :, None].to(torch.int32)
    key = torch.where(idx < valid_n, d * stride + idx, INT32_MAX)
    return key.reshape(q, m * L)


def fused_rescan_keys(packed_q: torch.Tensor, canon_bg_flat: torch.Tensor,
                      cols: torch.Tensor, stride: int,
                      valid_n: int) -> torch.Tensor:
    """(Q, W) queries, (C, L*W) group-major rows, (Q, M) winner columns ->
    (Q, M*L) int32 composite keys (INT32_MAX where idx >= valid_n).

    CUDA tensors launch ``csrc/fused_rescan.cu``, which also does the row
    gather (the reference gathers with an XLA take before its kernel); CPU
    tensors run ``_rescan_winner_columns``. L, C and W come from the shapes
    (the reference passes them as static arguments)."""
    if canon_bg_flat.device.type == "cpu":
        return _rescan_winner_columns(packed_q, canon_bg_flat, cols, stride,
                                      valid_n)
    q, w = packed_q.shape
    c, lw = canon_bg_flat.shape
    _check_kernel_args(packed_q, w)
    if lw % w:
        raise ValueError(f"row width {lw} is not a multiple of {w} words")
    L = lw // w
    m = cols.shape[1]
    cols = cols.to(torch.int32).contiguous()
    _build.require_cuda_tensor(packed_q, "packed_q", torch.int32, 2)
    _build.require_cuda_tensor(canon_bg_flat, "canon_bg_flat", torch.int32, 2)
    _build.require_cuda_tensor(cols, "cols", torch.int32, 2)
    out = torch.empty((q, m * L), dtype=torch.int32, device=cols.device)
    if out.numel():
        _build.KERNELS.launch(
            "fused_rescan", cols.device, packed_q.data_ptr(),
            canon_bg_flat.data_ptr(), cols.data_ptr(), out.data_ptr(), q, m,
            w, L, c, int(valid_n), stride)
    return out


# --------------------------------------------------------------------------
# 2 + 4. Selection and decode
# --------------------------------------------------------------------------

def _twolevel_topk_min(keys: torch.Tensor, kk: int, g: int = SUB_G,
                       submins: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kk smallest of (Q, M) DISTINCT int32 keys, ascending, and their
    int64 positions in M. Any top-kk key lives in a subgroup (g consecutive
    keys) whose minimum is among the kk smallest subgroup minima, so top-kk
    over M reduces to top-kk over the M/g minima plus top-kk over the kk*g
    surviving candidates. Takes one direct top-k when that cannot shrink the
    problem (same condition as the reference, ``mxu_scan.py:623``)."""
    q, m = keys.shape
    n_sub = m // g
    if n_sub < kk or m <= 4 * kk or m % g != 0 or kk * g >= m:
        return torch.topk(keys, kk, dim=1, largest=False)
    sub = keys.view(q, n_sub, g)
    if submins is None:
        submins = sub.amin(dim=2)
    _, sids = torch.topk(submins, kk, dim=1, largest=False)       # (Q, kk)
    cand = torch.gather(sub, 1, sids[:, :, None].expand(q, kk, g))
    vals, p = torch.topk(cand.reshape(q, kk * g), kk, dim=1, largest=False)
    lane = torch.arange(g, device=keys.device)
    pos = torch.gather((sids[:, :, None] * g + lane).reshape(q, kk * g), 1, p)
    return vals, pos


def mxu_topk(packed_q: torch.Tensor, gallery_g: torch.Tensor,
             canon_bg_flat: torch.Tensor, valid_n: int, k: int = 100,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of (Q, W) packed queries against a grouped gallery: the
    reference's ``mxu_topk(mode="exact")``. Its approx mode rests on
    ``lax.approx_min_k``, which has no PyTorch counterpart yet.

    Returns (distances (Q, kk) int32, indices (Q, kk) int32) with
    kk = min(k, L*C), oracle-bit-identical; entries with index >= valid_n
    are padding sentinels (d = bits + 1)."""
    q, w = packed_q.shape
    _, L, c = gallery_g.shape
    n_total = L * c
    bits = 32 * w
    stride = check_key_space(bits, n_total)
    kk = min(k, n_total)
    m = min(kk, c)  # winner columns per query (capped by the column count)

    full, sub = mxu_fullkey_scan(packed_q, gallery_g, valid_n, stride)
    _, cols = _twolevel_topk_min(full, m, submins=sub)
    rescan = fused_rescan_keys(packed_q, canon_bg_flat, cols, stride, valid_n)
    final, _ = _twolevel_topk_min(rescan, kk)
    is_pad = final == INT32_MAX
    d = torch.where(is_pad, bits + 1, final // stride).to(torch.int32)
    i = torch.where(is_pad, n_total, final % stride).to(torch.int32)
    return d, i
