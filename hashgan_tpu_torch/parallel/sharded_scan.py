"""Sharded-gallery Hamming top-k (port of
``hashgan_tpu/parallel/sharded_scan.py``).

The gallery is split over the mesh in contiguous shards: shard r owns the
global ids [r * n_loc, (r + 1) * n_loc). Every shard runs the port's
single-device engine on its own device, its ids are offset to global ones,
and the k candidates of every shard are gathered on the mesh's first device
and merged with one more selection, so a query costs k candidates a shard
in traffic, not the gallery.

Each function launches every shard's scan before it gathers anything: no
host sync (``.item()``, ``.cpu()``, a synchronize) runs between shards, so
shards on distinct GPUs overlap. The reference's collectives become copies:

- ``all_gather`` of the (Q, kk) candidates: each shard's result copied to
  the first device (``.to(..., non_blocking=True)``; peer to peer between
  GPUs, nothing on one device) and concatenated in shard order;
- ``ppermute`` of ``ring_hamming_topk``: each query block and its
  accumulators copied to the next device of the ring.

A cross-device copy orders itself against both devices' current streams,
so no explicit synchronize is needed. The reference caches one jitted
``shard_map`` per configuration (``_cached_shard_fn``); eager PyTorch
compiles nothing, so there is nothing to cache.

Exactness: each shard's list is (distance asc, index asc) over a contiguous
id range, so for equal distances the position in the shard-ordered
concatenation orders exactly like the global id. The merge key
``d * n_cand + position`` (n_cand = shards * kk) is distinct for every
candidate that is not padding and fits at any gallery size; every merge
selects over distinct keys (``torch.topk`` promises no tie order), and its
padding sentinels (d > bits) all decode to the same (bits + 1, n). The
keys are int64 here (the reference's int32 holds them wherever a merge can
run). The results are bit-identical to the reference's and to the port's
single-device engines.

Arguments that the reference takes as arrays sharded over the mesh are
sequences of per-shard tensors here, one on each mesh device in mesh order
(what ``shard_grouped_gallery`` returns); a whole tensor (a (W, N)
gallery, or a stack of per-shard layouts along a leading axis) is split
over the mesh on the way in (``_shards``). Queries may lie on any device; each shard
reads a copy on its own.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hashgan_tpu_torch.ops.groupmin import groupmin_topk, to_grouped_layout
from hashgan_tpu_torch.ops.hamming import hamming_scan_topk
from hashgan_tpu_torch.ops.mxu_large_k import (
    _compact_masked,
    count_select_threshold,
    mxu_topk_large,
)
from hashgan_tpu_torch.ops.mxu_scan import (
    grouped_to_pm8,
    mxu_topk,
    to_group_major,
)
from hashgan_tpu_torch.parallel.mesh import Mesh, shard_valid

INT64_MAX = torch.iinfo(torch.int64).max


def _shards(mesh: Mesh, x, dim: Optional[int] = None) -> List[torch.Tensor]:
    """Per-shard tensors, one on each mesh device in mesh order. A sequence
    is checked against the mesh; a whole tensor is split along ``dim`` into
    ``mesh.size`` equal chunks or, with ``dim=None``, taken as a stack of
    per-shard tensors along its leading axis; chunk r is copied to
    ``mesh.devices[r]``."""
    if isinstance(x, torch.Tensor):
        if dim is None:
            if x.shape[0] != mesh.size:
                raise ValueError(f"a stack of {x.shape[0]} shards for a mesh "
                                 f"of {mesh.size}")
            parts = x.unbind(0)
        elif x.shape[dim] % mesh.size:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} is not "
                             f"divisible by the mesh size {mesh.size}")
        else:
            parts = torch.chunk(x, mesh.size, dim=dim)
        return [p.to(d).contiguous() for p, d in zip(parts, mesh.devices)]
    x = list(x)
    if len(x) != mesh.size:
        raise ValueError(f"{len(x)} shards for a mesh of {mesh.size}")
    for r, (t, d) in enumerate(zip(x, mesh.devices)):
        if t.device != d:
            raise ValueError(f"shard {r} lies on {t.device}, its mesh "
                             f"position on {d}")
    return x


def _gathered(mesh: Mesh, parts: Sequence[torch.Tensor],
              dim: int = 1) -> torch.Tensor:
    """The all-gather: every shard's tensor on the first device,
    concatenated in shard order along ``dim``."""
    home = mesh.devices[0]
    return torch.cat([p.to(home, non_blocking=True) for p in parts], dim=dim)


def _merge(cat_d: torch.Tensor, cat_i: torch.Tensor, k_out: int, max_d: int,
           n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The position-key merge of the shard-ordered candidates: the k_out
    smallest ``d * n_cand + position``, padding (d > max_d) after every
    real item and returned as (max_d + 1, n). The sort engine's sentinels
    already have d = max_d + 1, so the reference's ``sharded_hamming_topk``,
    which rewrites only the id, gives the same."""
    n_cand = cat_d.shape[1]
    position = torch.arange(n_cand, dtype=torch.int64, device=cat_d.device)
    key = torch.where(cat_d > max_d, INT64_MAX,
                      cat_d.to(torch.int64) * n_cand + position)
    _, pos = torch.topk(key, k_out, dim=1, largest=False, sorted=True)
    return _decoded(cat_d, cat_i, pos, max_d, n)


def _decoded(cat_d, cat_i, pos, max_d, n):
    """The candidates at the selected positions, padding as (max_d + 1, n)."""
    d_out = torch.gather(cat_d, 1, pos)
    i_out = torch.gather(cat_i, 1, pos)
    sent = d_out > max_d
    return (torch.where(sent, max_d + 1, d_out).to(torch.int32),
            torch.where(sent, n, i_out).to(torch.int32))


def sharded_hamming_topk(
    mesh: Mesh, packed_q: torch.Tensor, gallery_t, k: int = 100,
    slab: int = 1 << 17, valid_n: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, W) queries x a (W, N) scan-layout gallery split on N -> top-k by
    the sort engine (``hamming_scan_topk``) on every shard, merged:
    (distances (Q, min(k, N)), global ids) int32 on the first device; ids
    >= N mark padding. N must divide by the mesh size (the gallery pads at
    build time); ``valid_n`` is the true item count."""
    shards = _shards(mesh, gallery_t, 1)
    local_n = shards[0].shape[1]
    n = local_n * mesh.size
    max_d = 32 * packed_q.shape[1]
    valid_n = n if valid_n is None else int(valid_n)
    ds, is_ = [], []
    for r, (dev, g) in enumerate(zip(mesh.devices, shards)):
        d, i = hamming_scan_topk(packed_q.to(dev), g, k=min(k, local_n),
                                 slab=slab,
                                 valid_n=shard_valid(valid_n, r, local_n))
        ds.append(d)
        is_.append(i + r * local_n)  # local -> global ids
    return _merge(_gathered(mesh, ds), _gathered(mesh, is_), min(k, n),
                  max_d, n)


def ring_hamming_topk(
    mesh: Mesh, packed_q: torch.Tensor, gallery_t, k: int = 100,
    slab: int = 1 << 17, valid_n: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ring variant: gallery shards stay resident while query blocks
    travel. The Q queries (Q divisible by the mesh size) are split into
    blocks, block r starting on device r; at each of ``mesh.size`` steps
    every device scans the block it holds against its shard, writes the
    shard's candidates into the block's accumulator slot of that shard id
    (so the slots end up in shard order whatever the visiting order), and
    passes block and accumulators to the next device. Home again, each
    block merges its slots with the same position key as
    ``sharded_hamming_topk``, so the result is bit-identical to it. Returns
    (distances (Q, min(k, N)), global ids) on the first device, in the
    original query order."""
    shards = _shards(mesh, gallery_t, 1)
    nd = mesh.size
    local_n = shards[0].shape[1]
    n = local_n * nd
    q = packed_q.shape[0]
    if q % nd:
        raise ValueError(f"queries {q} not divisible by mesh size {nd}")
    max_d = 32 * packed_q.shape[1]
    valid_n = n if valid_n is None else int(valid_n)
    kk_loc = min(k, local_n)
    q_loc = q // nd
    # carry[p]: (query block, distance slots, id slots) held by device p
    carry = []
    for dev, block in zip(mesh.devices, torch.chunk(packed_q, nd)):
        carry.append((block.to(dev),
                      torch.full((q_loc, nd, kk_loc), max_d + 1,
                                 dtype=torch.int32, device=dev),
                      torch.full((q_loc, nd, kk_loc), n, dtype=torch.int32,
                                 device=dev)))
    for _ in range(nd):
        for me, (dev, g) in enumerate(zip(mesh.devices, shards)):
            qb, d_acc, i_acc = carry[me]
            d, i = hamming_scan_topk(qb, g, k=kk_loc, slab=slab,
                                     valid_n=shard_valid(valid_n, me, local_n))
            d_acc[:, me] = d
            i_acc[:, me] = i + me * local_n
        # the ppermute: every block moves one device along the ring
        carry = [tuple(t.to(mesh.devices[p], non_blocking=True)
                       for t in carry[(p - 1) % nd]) for p in range(nd)]
    outs = [_merge(d_acc.view(q_loc, nd * kk_loc),
                   i_acc.view(q_loc, nd * kk_loc), min(k, n), max_d, n)
            for _, d_acc, i_acc in carry]
    return (_gathered(mesh, [o[0] for o in outs], dim=0),
            _gathered(mesh, [o[1] for o in outs], dim=0))


# ----------------------------------------------------------------------------
# Grouped layouts over the mesh, and the grouped engines on them
# ----------------------------------------------------------------------------

def shard_grouped_gallery(
    mesh: Mesh, packed, groups: int = 128, col_multiple: int = 256,
):
    """(N, W) canonical codes (int32 tensor, or a uint32 / int32 array) ->
    per-shard layouts, each built on its shard's device:
    (grouped (W, L, C_loc) a shard, canonical (n_loc, W) a shard, valids
    (nd,) int32 numpy, group-major rows (C_loc, L*W) a shard, n_loc).
    Shard r owns the contiguous items [r * n_loc, (r + 1) * n_loc), zero
    padded at the end, so a shard's local id order is the global one."""
    if not isinstance(packed, torch.Tensor):
        packed = torch.from_numpy(np.ascontiguousarray(packed).view(np.int32))
    nd = mesh.size
    n, w = packed.shape
    unit = groups * col_multiple
    n_loc = max(1, -(-n // (nd * unit))) * unit
    if n_loc * nd != n:
        packed = torch.cat([packed, packed.new_zeros((n_loc * nd - n, w))])
    grouped, canon, bg = [], [], []
    for dev, part in zip(mesh.devices, torch.chunk(packed, nd)):
        part = part.to(dev).contiguous()
        canon.append(part)
        grouped.append(to_grouped_layout(part, groups, col_multiple))
        g_major = to_group_major(part, groups, col_multiple)   # (C, L, W)
        bg.append(g_major.view(g_major.shape[0], -1))
    valids = np.clip(n - np.arange(nd) * n_loc, 0, n_loc).astype(np.int32)
    return tuple(grouped), tuple(canon), valids, tuple(bg), n_loc


def shard_pm8_gallery(mesh: Mesh, grouped, col_block: int = 128,
                      ) -> Tuple[torch.Tensor, ...]:
    """Per-shard grouped layouts -> per-shard +-1 int8 copies
    (``grouped_to_pm8``), each built on its shard's device."""
    return tuple(grouped_to_pm8(g, col_block)
                 for g in _shards(mesh, grouped))


def sharded_groupmin_topk(
    mesh: Mesh, packed_q: torch.Tensor, grouped, canon_bg, valids, n: int,
    k: int = 100, repair: int = 16, exact: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The min2 (repair) engine (``groupmin_topk``) on every shard, merged:
    (distances, global ids, needs_fallback (Q,) bool, the shards' flags
    OR-ed), on the first device. The reference reads each shard's canonical
    copy for its rescan; the port's engine reads the group-major rows,
    whose rescan keys are the same (ops/groupmin.py)."""
    grouped = _shards(mesh, grouped)
    canon_bg = _shards(mesh, canon_bg)
    _, L, c = grouped[0].shape
    n_loc = L * c
    max_d = 32 * packed_q.shape[1]
    kk = min(k, n_loc)
    ds, is_, fbs = [], [], []
    for r, (dev, g, bg) in enumerate(zip(mesh.devices, grouped, canon_bg)):
        d, i, fb = groupmin_topk(packed_q.to(dev), g, bg,
                                 valid_n=int(valids[r]), k=kk, repair=repair,
                                 exact=exact)
        ds.append(d)
        is_.append(i + r * n_loc)
        fbs.append(fb[None])
    d, i = _merge(_gathered(mesh, ds), _gathered(mesh, is_),
                  min(k, mesh.size * kk), max_d, n)
    return d, i, _gathered(mesh, fbs, dim=0).any(dim=0)


def sharded_mxu_topk(
    mesh: Mesh, packed_q: torch.Tensor, grouped, canon_bg, valids, n: int,
    k: int = 100, mode: str = "exact", gallery_pm8=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The column engine (``mxu_topk``: exact by the winner-column rescan,
    or approx) on every shard, merged: (distances (Q, min(k, nd * kk)),
    global ids) int32 on the first device, kk = min(k, n_loc); ids >= n
    mark padding. ``gallery_pm8``: per-shard +-1 copies
    (``shard_pm8_gallery``), which the shards' scans then read."""
    grouped = _shards(mesh, grouped)
    canon_bg = _shards(mesh, canon_bg)
    pm8 = (_shards(mesh, gallery_pm8) if gallery_pm8 is not None
           else [None] * mesh.size)
    _, L, c = grouped[0].shape
    n_loc = L * c
    max_d = 32 * packed_q.shape[1]
    kk = min(k, n_loc)
    ds, is_ = [], []
    for r, dev in enumerate(mesh.devices):
        d, i = mxu_topk(packed_q.to(dev), grouped[r], canon_bg[r],
                        valid_n=int(valids[r]), k=kk, mode=mode,
                        gallery_pm8=pm8[r])
        ds.append(d)
        is_.append(i + r * n_loc)
    return _merge(_gathered(mesh, ds), _gathered(mesh, is_),
                  min(k, mesh.size * kk), max_d, n)


def sharded_mxu_topk_large(
    mesh: Mesh, packed_q: torch.Tensor, grouped, canon_bg, valids, n: int,
    k: int = 1000, sigma: int = 16, mode: str = "exact",
    select: str = "sortdecode",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The subgroup engine (``mxu_topk_large``) on every shard, merged:
    (distances (Q, min(k, nd * kk)), global ids) on the first device. The
    merge keeps every key distinct, padding too:
    ``min(d, bits + 1) * n_cand + position``, so the counting select
    (``select="radix"``) finds exactly k keys at its threshold; exact mode
    selects as ``select`` says (``radix``: threshold, compaction and a
    sort; ``sortdecode``: one sort, the positions decoded from the keys;
    ``twolevel``: ``torch.topk``), approx mode by ``torch.topk``."""
    grouped = _shards(mesh, grouped)
    canon_bg = _shards(mesh, canon_bg)
    _, L, c = grouped[0].shape
    n_loc = L * c
    max_d = 32 * packed_q.shape[1]
    kk = min(k, n_loc)
    k_out = min(k, mesh.size * kk)
    ds, is_ = [], []
    for r, dev in enumerate(mesh.devices):
        d, i = mxu_topk_large(packed_q.to(dev), grouped[r], canon_bg[r],
                              valid_n=int(valids[r]), k=kk, sigma=sigma,
                              mode=mode, select=select)
        ds.append(d)
        is_.append(i + r * n_loc)
    cat_d, cat_i = _gathered(mesh, ds), _gathered(mesh, is_)
    n_cand = cat_d.shape[1]
    position = torch.arange(n_cand, dtype=torch.int64, device=cat_d.device)
    key = torch.clamp(cat_d.to(torch.int64), max=max_d + 1) * n_cand + position
    if mode == "exact" and select == "radix":
        hi = (max_d + 2) * n_cand
        if hi >= 2**31:
            raise ValueError(f"the counting select's keys reach {hi}, past "
                             "int32; use select='sortdecode'")
        tau = count_select_threshold(key, k_out, hi)
        merged = torch.sort(_compact_masked(key, key <= tau[:, None], k_out),
                            dim=1).values
        pos = merged % n_cand
    elif mode == "exact" and select == "sortdecode":
        pos = torch.sort(key, dim=1).values[:, :k_out] % n_cand
    else:
        _, pos = torch.topk(key, k_out, dim=1, largest=False, sorted=True)
    return _decoded(cat_d, cat_i, pos, max_d, n)
