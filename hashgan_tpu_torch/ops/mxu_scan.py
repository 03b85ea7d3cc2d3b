"""Hamming top-k by column minima: full-key scan, winner-column rescan, the
approx mode and the +-1 (pm8) scan copy.

Port of ``hashgan_tpu/ops/mxu_scan.py``. The algorithms are the reference's;
only the distance arithmetic changes with the hardware: the scans take the
packed words and run the +-1 product on the int8 tensor cores (the rescan
XORs and popcounts), and the plain twins XOR and popcount.

Exact mode (``mxu_topk``, the k <= 256 engine):

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

With a pm8 copy the scan is ``mxu8_groupmin_scan`` (kernel
``csrc/pm_groupmin_scan.cu``) and steps 2-4 run on the keys it gives.

Approx mode: the column minima (``mxu_groupmin_scan``, kernel
``csrc/groupmin_scan.cu``, or the pm8 scan) are the answer, without a
rescan: an item hidden behind a better item of its own column is missed.
The reference selects the m best minima with ``lax.approx_min_k``, which
PyTorch lacks. The port takes the exact m best over the distinct keys
``d * stride + s * C + c`` (ties of (d, s) go to the lower column, the
index order), so its recall is the column-collision term alone and any
``recall_target`` is met; the argument stays for parity. On the CPU, JAX's
``approx_min_k`` also returns the exact minima: the distances agree row for
row, the indices may differ among equal keys.

Total order: (distance asc, database index asc) — the numpy oracle's.
Each kernel has its plain PyTorch twin in this module; the wrappers use the
plain version only for CPU tensors and launch the kernel (or raise) for
CUDA tensors.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import torch

from hashgan_tpu_torch.ops import _build
from hashgan_tpu_torch.ops.groupmin import (
    INT32_MAX,
    layout_columns,
    pad_to_layout,
)
from hashgan_tpu_torch.ops.pack import popcount32
from hashgan_tpu_torch.utils.profiling import span

SUB_G = 16     # columns per subgroup minimum (reference: sub_g=16)
MODES = ("exact", "approx")
# Padding penalty of the float32 local keys d*L + s: layout-padding items
# get +2**22, above every valid key (< (bits + 1) * L) and still exact in
# float32 (reference ``mxu_scan.py:50``).
PAD_PENALTY = 1 << 22
# The grid of kernels 2, 5 and 6 (csrc/grouped_scan.cuh): 256 queries a row.
GROUPED_MAX_QUERIES = 65535 * 256
# Kernel 8's grid (csrc/pm_groupmin_scan.cu): query blocks of up to 256
# along x, whose queries must index as int.
PM8_MAX_QUERIES = 2**31 - 256


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


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


def unpack_to_pm8(packed: torch.Tensor) -> torch.Tensor:
    """(Q, W) int32 words -> (Q, 32W) +-1 int8, in unpack_to_pm1's order."""
    return unpack_to_pm1(packed, torch.int8)


def _layout_index(L: int, cols: int, device) -> torch.Tensor:
    """(L, cols) int32 item index s * cols + c."""
    return (torch.arange(L, dtype=torch.int32, device=device)[:, None] * cols
            + torch.arange(cols, dtype=torch.int32, device=device)[None, :])


def build_key_base(L: int, cols: int, bits: int, valid_n: int,
                   device=None) -> torch.Tensor:
    """(L, cols) float32 key base of the +-1 scans: B*L/2 + s, +2**22 on
    padding items (index >= valid_n)."""
    idx = _layout_index(L, cols, device)
    s = torch.arange(L, dtype=torch.float32, device=device)[:, None]
    base = (bits * L) / 2.0 + s.expand(L, cols)
    return torch.where(idx < valid_n, base, base + float(PAD_PENALTY))


def build_key_base_i32(L: int, cols: int, bits: int, valid_n: int,
                       device=None) -> torch.Tensor:
    """int32 key base of the int8 scan: build_key_base's values as exact
    integers."""
    idx = _layout_index(L, cols, device)
    s = torch.arange(L, dtype=torch.int32, device=device)[:, None]
    base = (bits * L) // 2 + s.expand(L, cols)
    return torch.where(idx < valid_n, base, base + PAD_PENALTY)


def grouped_to_pm8(gallery_g: torch.Tensor, col_block: int = 128,
                   dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """(W, L, C) packed grouped gallery -> (B, C//cb, L, cb) +-1 copy in the
    block layout the pm8 scan reads (row b = bit 32w + i, as unpack_to_pm8
    orders the query). 8x the packed bytes at int8: 134 MB for 1M x 128
    bits. Built on the gallery's device, one word at a time."""
    w, L, c = gallery_g.shape
    if c % col_block:
        raise ValueError(f"column count {c} is not a multiple of {col_block}")
    nb = c // col_block
    out = torch.empty((w * 32, nb, L, col_block), dtype=dtype,
                      device=gallery_g.device)
    shifts = torch.arange(32, dtype=torch.int32, device=gallery_g.device)
    for wi in range(w):
        bits = (gallery_g[wi][None] >> shifts[:, None, None]) & 1  # (32, L, C)
        pm = (bits * 2 - 1).to(dtype).view(32, L, nb, col_block)
        out[wi * 32:(wi + 1) * 32] = pm.permute(0, 2, 1, 3)
    return out


def check_key_space(bits: int, n_total: int) -> int:
    """The composite keys' int32 bound (reference ``mxu_scan.py:690``);
    returns ``stride``."""
    stride = n_total + 1
    if (bits + 1) * stride + n_total >= 2**31:
        raise ValueError(
            f"composite keys overflow int32 at {n_total} layout items x "
            f"{bits} bits; galleries past groupmin_capacity_ok take the "
            "slabbed engine (ops/slab_scan.py)"
        )
    return stride


def chunked_distances(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                      ) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """Yields (lo, hi, d) with d the (hi - lo, L, C) int32 Hamming distances
    of queries lo..hi-1 to the grouped (W, L, C) gallery; chunked over
    queries so the (chunk, W, L, C) XOR intermediate stays near 2**24
    elements. The scans' plain twins reduce d."""
    q = packed_q.shape[0]
    w, L, c = gallery_g.shape
    chunk = max(1, (1 << 24) // max(1, w * L * c))
    for lo in range(0, q, chunk):
        hi = min(lo + chunk, q)
        x = gallery_g[None] ^ packed_q[lo:hi, :, None, None]   # (ch, W, L, C)
        yield lo, hi, popcount32(x).sum(dim=1, dtype=torch.int32)


def local_keys(d: torch.Tensor, valid_n: int) -> torch.Tensor:
    """(ch, L, C) distances -> the TPU scans' local keys d*L + s, +2**22 on
    padding items, as int32 (exact integers below 2**24)."""
    _, L, c = d.shape
    idx = _layout_index(L, c, d.device)
    s = torch.arange(L, dtype=torch.int32, device=d.device)[:, None]
    return d * L + torch.where(idx < valid_n, s, s + PAD_PENALTY)


# --------------------------------------------------------------------------
# 1. Full-key scan (kernel 2)
# --------------------------------------------------------------------------

def fullkey_scan_keys_torch(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                            valid_n: int, stride: int) -> torch.Tensor:
    """Plain version of the scan kernel: (Q, W) x (W, L, C) -> (Q, C) int32
    full composite keys."""
    q = packed_q.shape[0]
    _, L, c = gallery_g.shape
    idx = _layout_index(L, c, gallery_g.device)
    valid = idx < valid_n
    full = torch.empty((q, c), dtype=torch.int32, device=gallery_g.device)
    for lo, hi, d in chunked_distances(packed_q, gallery_g):
        key = torch.where(valid, d * stride + idx, INT32_MAX)
        full[lo:hi] = key.amin(dim=1)
    return full


def fullkey_scan_keys(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                      valid_n: int, stride: int) -> torch.Tensor:
    """(Q, W) packed queries x (W, L, C) grouped gallery -> (Q, C) int32
    full composite keys. CUDA tensors launch ``csrc/mxu_fullkey_scan.cu``
    (the int8 tensor-core walk of kernel 6 with one running minimum, decoded
    into the composite key); CPU tensors run ``fullkey_scan_keys_torch``."""
    w, L, c = gallery_g.shape
    _build.check_words(packed_q, w)
    if gallery_g.device.type == "cpu":
        return fullkey_scan_keys_torch(packed_q, gallery_g, valid_n, stride)
    if L > 65536:
        raise ValueError(f"the scan kernel takes at most 65536 groups, got {L}")
    _build.require_cuda_tensor(packed_q, "packed_q", torch.int32, 2)
    _build.require_cuda_tensor(gallery_g, "gallery_g", torch.int32, 3)
    q = packed_q.shape[0]
    _build.check_queries(q, GROUPED_MAX_QUERIES)
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
# Column-min scans of the approx and pm8 paths (kernels 6 and 8)
# --------------------------------------------------------------------------

def mxu_groupmin_scan_torch(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                            valid_n: int) -> torch.Tensor:
    """Plain version of kernel 6: (Q, C) float32 column minima of the local
    keys d*L + s (+2**22 on padding)."""
    q = packed_q.shape[0]
    c = gallery_g.shape[2]
    out = torch.empty((q, c), dtype=torch.float32, device=gallery_g.device)
    for lo, hi, d in chunked_distances(packed_q, gallery_g):
        out[lo:hi] = local_keys(d, valid_n).amin(dim=1).to(torch.float32)
    return out


def mxu_groupmin_scan(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                      valid_n: int) -> torch.Tensor:
    """(Q, W) packed queries x (W, L, C) grouped gallery -> (Q, C) float32
    column-min keys d*L + s (+2**22 where the whole column is padding), the
    reference's ``mxu_groupmin_scan`` output. It takes the packed queries
    and ``valid_n`` where the TPU kernel takes +-1 queries and a key base.
    CUDA tensors launch ``csrc/groupmin_scan.cu``; CPU tensors run
    ``mxu_groupmin_scan_torch``."""
    w, L, c = gallery_g.shape
    _build.check_words(packed_q, w)
    if (32 * w + 1) * L >= PAD_PENALTY:
        raise ValueError(f"local keys d*L + s overflow 2**22 at L={L}")
    if gallery_g.device.type == "cpu":
        return mxu_groupmin_scan_torch(packed_q, gallery_g, valid_n)
    if L > 65536:
        raise ValueError(f"the scan kernel takes at most 65536 groups, got {L}")
    q = packed_q.shape[0]
    _build.check_queries(q, GROUPED_MAX_QUERIES)
    _build.require_cuda_tensor(packed_q, "packed_q", torch.int32, 2)
    _build.require_cuda_tensor(gallery_g, "gallery_g", torch.int32, 3)
    out = torch.empty((q, c), dtype=torch.float32, device=gallery_g.device)
    if out.numel():
        _build.KERNELS.launch(
            "groupmin_scan", gallery_g.device, packed_q.data_ptr(),
            gallery_g.data_ptr(), out.data_ptr(), q, w, L, c, int(valid_n))
    return out


def mxu8_groupmin_scan_torch(q_pm: torch.Tensor, gallery_pm: torch.Tensor,
                             key_base: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 8: min over s of base - (L/2) * q.g, with
    int32 sums for int8 operands and float32 sums for bf16 ones. The
    products are summed one bit at a time, over query chunks that keep the
    (chunk, L*C) sums near 2**25 elements."""
    b, nb, L, cb = gallery_pm.shape
    c = nb * cb
    int_path = gallery_pm.dtype == torch.int8
    acc_t = torch.int32 if int_path else torch.float32
    half_l = L // 2 if int_path else L / 2.0
    g = gallery_pm.permute(0, 2, 1, 3).reshape(b, L * c).to(acc_t)
    qv = q_pm.to(acc_t)
    q = q_pm.shape[0]
    out = torch.empty((q, c), dtype=acc_t, device=gallery_pm.device)
    chunk = max(1, (1 << 25) // max(1, L * c))
    for lo in range(0, q, chunk):
        hi = min(lo + chunk, q)
        dot = torch.zeros((hi - lo, L * c), dtype=acc_t, device=g.device)
        for bit in range(b):
            dot += qv[lo:hi, bit, None] * g[bit]
        key = key_base[None] - dot.view(hi - lo, L, c) * half_l
        out[lo:hi] = key.amin(dim=1)
    return out


def mxu8_groupmin_scan(q_pm: torch.Tensor, gallery_pm: torch.Tensor,
                       key_base: torch.Tensor) -> torch.Tensor:
    """(Q, B) +-1 queries x (B, C//cb, L, cb) +-1 gallery (grouped_to_pm8)
    + (L, C) key base -> (Q, C) column-min keys: int32 for int8 operands
    (key base from build_key_base_i32), float32 for bf16 ones
    (build_key_base). CUDA tensors launch ``csrc/pm_groupmin_scan.cu`` (both
    dtypes on the tensor cores, B = 32..256 in steps of 32); CPU tensors run
    ``mxu8_groupmin_scan_torch``."""
    b, nb, L, cb = gallery_pm.shape
    int_path = gallery_pm.dtype == torch.int8
    if not int_path and gallery_pm.dtype != torch.bfloat16:
        raise ValueError(f"the pm8 copy is int8 or bfloat16, got {gallery_pm.dtype}")
    if q_pm.dim() != 2 or q_pm.shape[1] != b or q_pm.dtype != gallery_pm.dtype:
        raise ValueError(f"queries must be (Q, {b}) {gallery_pm.dtype}, got "
                         f"{tuple(q_pm.shape)} {q_pm.dtype}")
    base_t = torch.int32 if int_path else torch.float32
    if key_base.shape != (L, nb * cb) or key_base.dtype != base_t:
        raise ValueError(f"key_base must be ({L}, {nb * cb}) {base_t}")
    if gallery_pm.device.type == "cpu":
        return mxu8_groupmin_scan_torch(q_pm, gallery_pm, key_base)
    if b % 4 or cb % 4:
        raise ValueError(f"the kernel takes B and cb multiples of 4, got {b}, {cb}")
    if b % 32 or not 32 <= b <= 32 * _build.MAX_WORDS:
        raise ValueError(f"the kernel takes B = 32..{32 * _build.MAX_WORDS}"
                         f" in steps of 32, got {b}")
    _build.require_cuda_tensor(q_pm, "q_pm", gallery_pm.dtype, 2)
    _build.require_cuda_tensor(gallery_pm, "gallery_pm", gallery_pm.dtype, 4)
    _build.require_cuda_tensor(key_base, "key_base", base_t, 2)
    if gallery_pm.data_ptr() % 16 or key_base.data_ptr() % 16 or q_pm.data_ptr() % 4:
        raise ValueError("gallery_pm and key_base must be 16-byte aligned, "
                         "q_pm 4-byte aligned")
    q = q_pm.shape[0]
    _build.check_queries(q, PM8_MAX_QUERIES)
    out = torch.empty((q, nb * cb), dtype=base_t, device=gallery_pm.device)
    if out.numel():
        _build.KERNELS.launch(
            "pm_groupmin_scan", gallery_pm.device, q_pm.data_ptr(),
            gallery_pm.data_ptr(), key_base.data_ptr(), out.data_ptr(), q, b,
            nb, L, cb, int(int_path))
    return out


def pm8_column_block(c: int) -> int:
    """Column block of a gallery's pm8 copy: the reference's 128, or the
    largest divisor of C below it for the small test layouts."""
    return math.gcd(c, 128)


# --------------------------------------------------------------------------
# 3. Winner rescan (kernel 3)
# --------------------------------------------------------------------------

def _rescan_rows(packed_q: torch.Tensor, canon_bg_flat: torch.Tensor,
                 rows: torch.Tensor, sigma: int, stride: int, valid_n: int,
                 pad_d: int) -> torch.Tensor:
    """Plain version of the rescan kernel: exact keys of every item of the
    winner rows. canon_bg_flat (C, L*W) cut into C*R rows of sigma items
    (R = L / sigma; row col*R + j holds s = j*sigma + s' of column col);
    rows (Q, M) row ids. Returns (Q, M*sigma) int32 keys d*stride + idx,
    and where idx >= valid_n INT32_MAX (pad_d < 0) or pad_d*stride + idx."""
    q, w = packed_q.shape
    c = canon_bg_flat.shape[0]
    L = canon_bg_flat.shape[1] // w
    r_sub = L // sigma
    m = rows.shape[1]
    rows = rows.to(torch.int32)
    taken = canon_bg_flat.reshape(c * r_sub, sigma * w)[rows.long()]
    d = popcount32(taken.view(q, m, sigma, w) ^ packed_q[:, None, None, :]).sum(
        dim=-1, dtype=torch.int32)                                # (Q, M, sigma)
    s = ((rows % r_sub)[:, :, None] * sigma
         + torch.arange(sigma, dtype=torch.int32, device=rows.device))
    idx = s * c + (rows // r_sub)[:, :, None]
    pad = (torch.full_like(idx, INT32_MAX) if pad_d < 0
           else pad_d * stride + idx)
    return torch.where(idx < valid_n, d * stride + idx, pad).reshape(q, m * sigma)


def _rescan_winner_columns(packed_q: torch.Tensor, canon_bg_flat: torch.Tensor,
                           cols: torch.Tensor, stride: int,
                           valid_n: int) -> torch.Tensor:
    """Plain version of the column rescan: exact keys of every item of the
    winner columns. canon_bg_flat (C, L*W); cols (Q, M) column ids in
    [0, C). Returns (Q, M*L) int32 keys, INT32_MAX where idx >= valid_n."""
    L = canon_bg_flat.shape[1] // packed_q.shape[1]
    return _rescan_rows(packed_q, canon_bg_flat, cols, L, stride, valid_n, -1)


def fused_rescan_keys(packed_q: torch.Tensor, canon_bg_flat: torch.Tensor,
                      cols: torch.Tensor, stride: int, valid_n: int,
                      sigma: Optional[int] = None, pad_d: int = -1,
                      ) -> torch.Tensor:
    """(Q, W) queries, (C, L*W) group-major rows, (Q, M) winner rows ->
    (Q, M*sigma) int32 composite keys. By default sigma = L: the rows are
    the winner columns and padding items get INT32_MAX (the reference's
    ``fused_rescan_keys``). The large-k engine passes sigma = 16 and
    pad_d = bits + 1 (the reference's ``_rescan_winner_subgroups``).

    CUDA tensors launch ``csrc/fused_rescan.cu``, which also does the row
    gather (the reference gathers with an XLA take before its kernel); CPU
    tensors run ``_rescan_rows``. L, C and W come from the shapes (the
    reference passes them as static arguments)."""
    q, w = packed_q.shape
    c, lw = canon_bg_flat.shape
    if lw % w:
        raise ValueError(f"row width {lw} is not a multiple of {w} words")
    L = lw // w
    sigma = L if sigma is None else sigma
    if L % sigma:
        raise ValueError(f"L={L} is not a multiple of sigma={sigma}")
    if canon_bg_flat.device.type == "cpu":
        return _rescan_rows(packed_q, canon_bg_flat, cols, sigma, stride,
                            valid_n, pad_d)
    _build.check_words(packed_q, w)
    m = cols.shape[1]
    cols = cols.to(torch.int32).contiguous()
    _build.require_cuda_tensor(packed_q, "packed_q", torch.int32, 2)
    _build.require_cuda_tensor(canon_bg_flat, "canon_bg_flat", torch.int32, 2)
    _build.require_cuda_tensor(cols, "cols", torch.int32, 2)
    out = torch.empty((q, m * sigma), dtype=torch.int32, device=cols.device)
    if out.numel():
        _build.KERNELS.launch(
            "fused_rescan", cols.device, packed_q.data_ptr(),
            canon_bg_flat.data_ptr(), cols.data_ptr(), out.data_ptr(), q, m,
            w, L, c, sigma, int(valid_n), stride, pad_d)
    return out


def rescan_columns(packed_q: torch.Tensor, canon_bg_flat: torch.Tensor,
                   cols: torch.Tensor, stride: int, valid_n: int,
                   fused: bool = True) -> torch.Tensor:
    """Stage 3 of the exact engine: (Q, M*L) int32 keys of every item of the
    winner columns ``cols``, through the fused kernel (``fused_rescan_keys``)
    or, with ``fused=False``, the plain gather + popcount (the reference's
    ``rescan_fused=False`` arm). Identical results."""
    if fused:
        return fused_rescan_keys(packed_q, canon_bg_flat, cols, stride, valid_n)
    return _rescan_winner_columns(packed_q, canon_bg_flat, cols, stride, valid_n)


# --------------------------------------------------------------------------
# 2 + 4. Selection and decode
# --------------------------------------------------------------------------

def _full_column_keys(min1: torch.Tensor, L: int, c: int,
                      stride: int) -> torch.Tensor:
    """(Q, C) column-min local keys d*L + s (float32 or int32) -> (Q, C)
    int32 full composite keys d*stride + s*C + col, DISTINCT for every
    column holding a valid item; all-padding columns (key >= 2**22) map to
    INT32_MAX. Computed in int64, so the padding lanes cannot overflow."""
    key = min1.to(torch.int64)
    cols = torch.arange(c, dtype=torch.int64, device=min1.device)
    full = (key // L) * stride + (key % L) * c + cols
    return torch.where(key >= PAD_PENALTY, INT32_MAX, full).to(torch.int32)


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


def winner_columns(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                   valid_n: int, stride: int, m: int) -> torch.Tensor:
    """Stages 1-2 of the exact engine: the full-key scan (kernel 2) and the
    (Q, m) int64 ids of the m columns holding each query's best column
    minima, the columns the rescan reads."""
    with span("scan.keys"):
        full, sub = mxu_fullkey_scan(packed_q, gallery_g, valid_n, stride)
    with span("scan.select"):
        return _twolevel_topk_min(full, m, submins=sub)[1]


def decode_keys(keys: torch.Tensor, stride: int, bits: int, n_total: int,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite keys -> (distances, indices) int32; any key whose distance
    part exceeds ``bits`` (INT32_MAX, (bits + 1) * stride + idx) is a
    padding sentinel (bits + 1, n_total)."""
    d = keys // stride
    is_pad = d > bits
    return (torch.where(is_pad, bits + 1, d).to(torch.int32),
            torch.where(is_pad, n_total, keys % stride).to(torch.int32))


def pad_sentinels(d: torch.Tensor, i: torch.Tensor, kk: int, bits: int,
                  n_total: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Right-pads (Q, m) results to kk columns with (bits + 1, n_total)."""
    extra = kk - d.shape[1]
    if extra <= 0:
        return d, i
    return (torch.nn.functional.pad(d, (0, extra), value=bits + 1),
            torch.nn.functional.pad(i, (0, extra), value=n_total))


def mxu_topk(packed_q: torch.Tensor, gallery_g: torch.Tensor,
             canon_bg_flat: torch.Tensor, valid_n: int, k: int = 100,
             mode: str = "exact", recall_target: float = 0.95,
             gallery_pm8: Optional[torch.Tensor] = None,
             rescan_fused: bool = True,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (Q, W) packed queries against a grouped gallery: the
    reference's ``mxu_topk``.

    Returns (distances (Q, kk) int32, indices (Q, kk) int32) with
    kk = min(k, L*C); entries with index >= valid_n are padding sentinels
    (d = bits + 1). ``mode="exact"``: oracle-bit-identical.
    ``mode="approx"``: the m = min(kk, C) best column minima (module doc;
    ``recall_target`` is met trivially). ``gallery_pm8``: the +-1 copy of
    the gallery (``grouped_to_pm8``); the scan then reads it instead of the
    packed words, with identical results. ``rescan_fused=False``: the exact
    rescan runs the plain gather + popcount (``rescan_columns``)."""
    check_mode(mode)
    q, w = packed_q.shape
    _, L, c = gallery_g.shape
    n_total = L * c
    bits = 32 * w
    stride = check_key_space(bits, n_total)
    kk = min(k, n_total)
    m = min(kk, c)  # winner columns per query (capped by the column count)

    if mode == "exact" and gallery_pm8 is None:
        cols = winner_columns(packed_q, gallery_g, valid_n, stride, m)
        return _rescan_and_merge(packed_q, canon_bg_flat, cols, stride,
                                 valid_n, rescan_fused, kk, bits, n_total)

    with span("scan.keys"):
        if gallery_pm8 is not None:
            dev = gallery_pm8.device
            if gallery_pm8.dtype == torch.int8:
                qv = unpack_to_pm8(packed_q)
                kb = build_key_base_i32(L, c, bits, valid_n, dev)
            else:
                qv = unpack_to_pm1(packed_q, gallery_pm8.dtype)
                kb = build_key_base(L, c, bits, valid_n, dev)
            min1 = mxu8_groupmin_scan(qv, gallery_pm8, kb)
        else:
            min1 = mxu_groupmin_scan(packed_q, gallery_g, valid_n)
        full = _full_column_keys(min1, L, c, stride)

    if mode == "approx":
        with span("scan.select"):
            keys, _ = torch.topk(full, m, dim=1, largest=False)
        with span("scan.merge"):
            d, i = decode_keys(keys, stride, bits, n_total)
            return pad_sentinels(d, i, kk, bits, n_total)

    with span("scan.select"):
        _, cols = _twolevel_topk_min(full, m)
    return _rescan_and_merge(packed_q, canon_bg_flat, cols, stride, valid_n,
                             rescan_fused, kk, bits, n_total)


def _rescan_and_merge(packed_q, canon_bg_flat, cols, stride, valid_n,
                      rescan_fused, kk, bits, n_total):
    """Stages 3-4 of the exact engine: the winner columns' rescan, then the
    kk smallest keys decoded."""
    with span("scan.rescan"):
        rescan = rescan_columns(packed_q, canon_bg_flat, cols, stride,
                                valid_n, fused=rescan_fused)
    with span("scan.merge"):
        final, _ = _twolevel_topk_min(rescan, kk)
        return decode_keys(final, stride, bits, n_total)
