"""Per-slab rebased keys: the grouped engines past the int32 composite
ceiling (port of ``hashgan_tpu/ops/slab_scan.py``).

The grouped engines encode (distance, index) in one int32 key, which caps
one layout at ~16.4M items at 128 bits. A larger gallery is cut into
contiguous slabs that each fit the key space; every slab runs the unchanged
engine (``grouped_topk``; approx slabs on the subgroup engine at every k)
with slab-local keys, and the per-slab lists merge on a position key: the
slabs are ascending index ranges and each list is (distance asc, index
asc), so ``d * n_cand + position`` orders as the global (d, idx) does, and
fits int32 at any gallery size. The reference runs the slabs under one
``lax.scan``; the port loops over them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from hashgan_tpu_torch.ops.mxu_large_k import grouped_topk
from hashgan_tpu_torch.ops.mxu_scan import check_mode


def mxu_slab_capacity(words: int, groups: int = 128,
                      col_multiple: int = 256) -> int:
    """Largest multiple of the layout unit that satisfies the strictest
    slab engine's key bound, mxu_topk_large's (bits+2)*(n+1) + n < 2**31:
    16,384,000 items at 128 bits."""
    bits = 32 * words
    unit = groups * col_multiple
    nt_max = (2**31 - bits - 2) // (bits + 3)
    return max(unit, (nt_max // unit) * unit)


def build_slabbed_layout(packed: torch.Tensor, groups: int = 128,
                         col_multiple: int = 256, slab_items: int | None = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray, int]:
    """(N, W) int32 packed codes -> stacked per-slab layouts, built on the
    codes' device by reshapes and transposes:
    (gallery_gs (S, W, L, C), canon_bgs (S, C, L*W), valids (S,) int32,
    slab_items). Slab s owns the items [s*slab_items, (s+1)*slab_items),
    zero-padded at the end; contiguity is what makes the merge exact."""
    n, w = packed.shape
    if slab_items is None:
        slab_items = mxu_slab_capacity(w, groups, col_multiple)
    unit = groups * col_multiple
    if slab_items % unit:
        raise ValueError(f"slab_items {slab_items} is not a multiple of {unit}")
    s = max(1, -(-n // slab_items))
    if s * slab_items != n:
        packed = torch.cat([packed, packed.new_zeros((s * slab_items - n, w))])
    c = slab_items // groups
    cube = packed.view(s, groups, c, w)
    gallery_gs = cube.permute(0, 3, 1, 2).contiguous()
    # contiguous first: at W = 1 a reshape alone would return a strided view
    canon_bgs = cube.permute(0, 2, 1, 3).contiguous().view(s, c, groups * w)
    valids = np.clip(n - np.arange(s) * slab_items, 0, slab_items).astype(
        np.int32)
    return gallery_gs, canon_bgs, valids, slab_items


def mxu_topk_slabbed(packed_q: torch.Tensor, gallery_gs: torch.Tensor,
                     canon_bgs: torch.Tensor, valids: Sequence[int], n: int,
                     slab_items: int, k: int = 100, mode: str = "exact",
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a slabbed gallery, with mxu_topk's contract: oracle rank
    order, sentinels (bits + 1, n) past the valid count. In approx mode each
    slab runs its approx path and the merge is exact over the candidates."""
    check_mode(mode)
    q, w = packed_q.shape
    s = gallery_gs.shape[0]
    _, _, L, c = gallery_gs.shape
    bits = 32 * w
    kk_loc = min(k, L * c)
    ds, is_ = [], []
    for j in range(s):
        d, i = grouped_topk(packed_q, gallery_gs[j], canon_bgs[j],
                            valid_n=int(valids[j]), k=kk_loc, mode=mode,
                            column_approx=False)
        ds.append(d)
        is_.append(i + j * slab_items)
    cat_d = torch.cat(ds, dim=1)
    cat_i = torch.cat(is_, dim=1)
    n_cand = cat_d.shape[1]
    position = torch.arange(n_cand, dtype=torch.int64, device=cat_d.device)
    # (d, position) orders as (d, global idx); sentinels (d = bits + 1)
    # get distinct keys that sort last.
    key = torch.clamp(cat_d.to(torch.int64), max=bits + 1) * n_cand + position
    _, pos = torch.topk(key, min(k, s * kk_loc), dim=1, largest=False)
    d_out = torch.gather(cat_d, 1, pos)
    i_out = torch.gather(cat_i, 1, pos)
    sent = d_out > bits
    return (torch.where(sent, bits + 1, d_out).to(torch.int32),
            torch.where(sent, n, i_out).to(torch.int32))
