"""Device-resident packed Hamming gallery: build, update, persist, query.

Port of ``hashgan_tpu/index/gallery.py``. A single-device gallery holds
layouts of the same int32 words, all built on its device by reshapes and
transposes:

- ``packed_canonical`` (n_layout, W): items in id order, zero-padded to the
  grouped layout (not padded in a slabbed gallery);
- ``gallery_grouped`` (W, L, C): what the grouped scans read;
- ``canon_bg`` (C, L*W): group-major rows, what the rescans read;
- ``gallery_pm8`` (B, C/cb, L, cb): the opt-in +-1 int8 scan copy
  (``build_pm8=True``), within ``PM8_BUDGET_BYTES``;
- ``gallery_slabbed``: per-slab layouts in place of the two grouped ones
  for galleries past ``groupmin_capacity_ok`` (ops/slab_scan.py).

``topk`` takes the reference's single-device routes: the k <= 256 column
engine, the large-k subgroup engine up to ``large_k_max``, the slabbed
engine, the min2 engine for an explicit ``repair``, and the sort engine
(``hamming_scan_topk``) beyond. Its scan-layout (W, N) copy is made from
``packed_canonical`` at the first call that needs it.

A gallery over a mesh of more than one position (``mesh``,
``parallel/mesh.py``) is split in contiguous shards, each on its mesh
device: ``gallery_t``, the (W, N_pad) scan layout (N padded to a multiple
of 8 * mesh size) in per-shard column blocks, and, where a shard fits
``groupmin_capacity_ok``, ``gallery_grouped`` = (grouped, canonical,
valids, group-major rows, pm8 copy or None), per-shard tuples from
``parallel/sharded_scan.py::shard_grouped_gallery``. ``topk`` then takes
the reference's mesh routes: ``sharded_mxu_topk`` at k <= 256,
``sharded_mxu_topk_large`` up to ``large_k_max``, ``sharded_groupmin_topk``
for an explicit ``repair`` (its fallback by the sharded sort engine), and
``sharded_hamming_topk`` beyond, or for every k where the shards have no
grouped layout. Results come back on the mesh's first device, which is the
gallery's ``device``. A mesh gallery is extended and trimmed through the
host (resharding needs it, as in the reference). A mesh of one position
builds exactly the single-device gallery.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from hashgan_tpu_torch.ops.groupmin import (
    groupmin_capacity_ok,
    groupmin_topk,
    pad_to_layout,
    to_grouped_layout,
)
from hashgan_tpu_torch.ops.hamming import hamming_scan_topk
from hashgan_tpu_torch.ops.mxu_large_k import MAX_K, grouped_topk
from hashgan_tpu_torch.ops.mxu_scan import (
    check_mode,
    grouped_to_pm8,
    pm8_column_block,
    to_group_major,
)
from hashgan_tpu_torch.ops.pack import pack_codes
from hashgan_tpu_torch.ops.slab_scan import build_slabbed_layout, mxu_topk_slabbed
from hashgan_tpu_torch.parallel.mesh import Mesh, pad_to_multiple
from hashgan_tpu_torch.parallel.sharded_scan import (
    _shards,
    shard_grouped_gallery,
    shard_pm8_gallery,
    sharded_groupmin_topk,
    sharded_hamming_topk,
    sharded_mxu_topk,
    sharded_mxu_topk_large,
)

GROUPS = 128        # L: items per column group
COL_MULTIPLE = 256  # C is padded to a multiple of this
LARGE_K_MAX = 8192  # deepest k of the subgroup engine (reference default)
PM8_BUDGET_BYTES = 512 * 1024 * 1024  # device bytes for the +-1 int8 copy


@dataclasses.dataclass
class PackedGallery:
    """labels: (N, K) host array; n: true item count; bits: logical width.
    Entries returned with index >= n are padding sentinels. On one device
    exactly one of (``gallery_grouped`` with ``canon_bg``) and
    ``gallery_slabbed`` is set: ``gallery_slabbed`` = (gallery_gs,
    canon_bgs, valids, slab_items). On a mesh of more than one position
    (``sharded``) ``packed_canonical`` is None, ``gallery_t`` holds the
    per-shard scan layouts and ``gallery_grouped``, where set, the
    per-shard tuple (grouped, canonical, valids, canon_bg, pm8 or None)."""

    packed_canonical: Optional[torch.Tensor]   # (n_layout >= n, W) int32
    labels: np.ndarray
    n: int
    bits: int
    gallery_grouped: Optional[torch.Tensor | tuple] = None  # (W, L, C) int32
    canon_bg: Optional[torch.Tensor] = None          # (C, L*W) int32
    gallery_pm8: Optional[torch.Tensor] = None       # (B, NB, L, cb) int8
    gallery_slabbed: Optional[tuple] = None
    mesh: Optional[Mesh] = None
    gallery_t: Optional[Tuple[torch.Tensor, ...]] = None  # (W, N_pad/nd) each
    _scan_t: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def sharded(self) -> bool:
        """Split over a mesh of more than one position."""
        return self.mesh is not None and self.mesh.size > 1

    @property
    def words(self) -> int:
        if self.sharded:
            return self.gallery_t[0].shape[0]
        return self.packed_canonical.shape[1]

    @property
    def device(self) -> torch.device:
        """Where queries are packed and results land: the mesh's first
        device for a sharded gallery."""
        if self.sharded:
            return self.mesh.devices[0]
        return self.packed_canonical.device

    def scan_layout(self) -> torch.Tensor:
        """(W, N8) scan-layout copy for the sort engine, N8 = n rounded up
        to a multiple of 8 (zero items past n): the reference's
        ``gallery_t``, made at the first call and kept (a gallery never
        changes; ``extend`` and ``remove`` build new ones)."""
        if self._scan_t is None:
            n8 = -(-self.n // 8) * 8
            canon = self.packed_canonical[:n8]
            if canon.shape[0] < n8:
                canon = torch.cat([canon, canon.new_zeros(
                    (n8 - canon.shape[0], self.words))])
            self._scan_t = canon.t().contiguous()
        return self._scan_t

    def topk(self, packed_q: torch.Tensor, k: int = 100, slab: int = 1 << 17,
             mode: str = "exact", repair: Optional[int] = None,
             large_k_max: int = LARGE_K_MAX,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k of (Q, W) int32 packed queries: (distances, indices) int32
        on the gallery's device; index >= n marks padding.

        mode: "exact" (oracle-bit-identical) or "approx" (the engines'
        minima without the rescan; see ops/mxu_scan.py). repair: selects the
        min2 engine with that rescan capacity; below k, queries whose
        flagged columns exceed it are recomputed by the sort engine (a host
        sync). large_k_max: deepest k of the subgroup engine; deeper
        queries stream through the sort engine. A sharded gallery takes the
        reference's mesh routes (module doc)."""
        check_mode(mode)
        packed_q = packed_q.to(self.device)
        if self.sharded:
            return self._mesh_topk(packed_q, k, slab, mode, repair,
                                   large_k_max)
        grouped = self.gallery_grouped is not None
        if grouped and repair is None and k <= large_k_max:
            return grouped_topk(packed_q, self.gallery_grouped, self.canon_bg,
                                valid_n=self.n, k=k, mode=mode,
                                gallery_pm8=self.gallery_pm8)
        if self.gallery_slabbed is not None and repair is None \
                and k <= large_k_max:
            gs, bgs, valids, slab_items = self.gallery_slabbed
            return mxu_topk_slabbed(packed_q, gs, bgs, valids, n=self.n,
                                    slab_items=slab_items, k=k, mode=mode)
        if grouped and repair is not None:
            _, L, c = self.gallery_grouped.shape
            kk = min(k, L * c)
            rep = min(repair, kk)
            d, i, fb = groupmin_topk(packed_q, self.gallery_grouped,
                                     self.canon_bg, valid_n=self.n, k=k,
                                     repair=rep, exact=(mode == "exact"))
            if mode == "exact" and rep < kk:
                # Reachable only with a repair capacity below k.
                rows = torch.nonzero(fb).flatten()
                if rows.numel():
                    d_fix, i_fix = hamming_scan_topk(
                        packed_q[rows], self.scan_layout(), k=min(k, self.n),
                        slab=slab, valid_n=self.n)
                    d[rows, :d_fix.shape[1]] = d_fix
                    i[rows, :i_fix.shape[1]] = i_fix
            return d, i
        return hamming_scan_topk(packed_q, self.scan_layout(), k=k, slab=slab,
                                 valid_n=self.n, mode=mode)

    def _mesh_topk(self, packed_q, k, slab, mode, repair, large_k_max):
        """The reference's mesh routes (``gallery.py:88-130``)."""
        mesh = self.mesh
        if self.gallery_grouped is None:
            return sharded_hamming_topk(mesh, packed_q, self.gallery_t, k=k,
                                        slab=slab, valid_n=self.n)
        grouped, canon, valids, bg, pm8 = self.gallery_grouped
        if repair is None and k <= MAX_K:
            return sharded_mxu_topk(mesh, packed_q, grouped, bg, valids,
                                    n=self.n, k=k, mode=mode, gallery_pm8=pm8)
        if repair is None and k <= large_k_max:
            return sharded_mxu_topk_large(mesh, packed_q, grouped, bg, valids,
                                          n=self.n, k=k, mode=mode)
        if repair is None:
            return sharded_hamming_topk(mesh, packed_q, self.gallery_t, k=k,
                                        slab=slab, valid_n=self.n)
        kk_loc = min(k, canon[0].shape[0])
        rep = min(repair, kk_loc)
        d, i, fb = sharded_groupmin_topk(mesh, packed_q, grouped, bg, valids,
                                         n=self.n, k=k, repair=rep,
                                         exact=(mode == "exact"))
        if mode == "exact" and rep < kk_loc:
            # Reachable only with a repair capacity below k.
            rows = torch.nonzero(fb).flatten()
            if rows.numel():
                d_fix, i_fix = sharded_hamming_topk(
                    mesh, packed_q[rows], self.gallery_t, k=min(k, self.n),
                    slab=slab, valid_n=self.n)
                d[rows, :d_fix.shape[1]] = d_fix
                i[rows, :i_fix.shape[1]] = i_fix
        return d, i

    def canonical_packed(self) -> np.ndarray:
        """(n, W) uint32 canonical packed codes (host copy)."""
        if self.sharded:
            scan = torch.cat([g.cpu() for g in self.gallery_t], dim=1)
            return scan.t()[: self.n].contiguous().numpy().view(np.uint32)
        return self.packed_canonical[: self.n].cpu().numpy().view(np.uint32)

    def extend(self, codes, labels: np.ndarray) -> "PackedGallery":
        """Append items; returns a NEW gallery. New items take ids
        n..n+m-1 and existing ids are stable. The layouts (the pm8 copy
        too, if the gallery has one) are rebuilt on the device, and only
        the new codes cross to it; a sharded gallery is rebuilt from the
        host over the same mesh."""
        codes = torch.as_tensor(codes, dtype=torch.float32).to(self.device)
        packed_new = pack_codes(codes)
        labels_all = np.concatenate(
            [self.labels[: self.n], np.asarray(labels)], axis=0)
        if self.sharded:
            packed = np.concatenate([self.canonical_packed(),
                                     packed_new.cpu().numpy().view(np.uint32)])
            return build_gallery_from_packed(packed, labels_all, self.bits,
                                             mesh=self.mesh,
                                             build_pm8=self._has_pm8())
        packed = torch.cat([self.packed_canonical[: self.n], packed_new])
        return self._with_mesh(build_gallery_from_packed_device(
            packed, labels_all, self.bits, build_pm8=self._has_pm8()))

    def remove(self, ids) -> Tuple["PackedGallery", np.ndarray]:
        """Delete items; returns (new gallery, id_map) with
        ``id_map[new_id] = old_id``. Ids stay contiguous (the tie order ranks
        by database index, so holes would change rankings)."""
        mask = np.ones(self.n, dtype=bool)
        mask[np.asarray(ids)] = False
        keep = np.flatnonzero(mask)
        labels = self.labels[: self.n][keep]
        if self.sharded:
            gal = build_gallery_from_packed(
                self.canonical_packed()[keep], labels, self.bits,
                mesh=self.mesh, build_pm8=self._has_pm8())
            return gal, keep
        packed = self.packed_canonical[: self.n][
            torch.from_numpy(keep).to(self.device)]
        gal = build_gallery_from_packed_device(
            packed, labels, self.bits, build_pm8=self._has_pm8())
        return self._with_mesh(gal), keep

    def _with_mesh(self, gal: "PackedGallery") -> "PackedGallery":
        gal.mesh = self.mesh
        return gal

    def _has_pm8(self) -> bool:
        """True if this gallery carries the opt-in +-1 scan copy (extend and
        remove keep it)."""
        if self.sharded:
            return (self.gallery_grouped is not None
                    and self.gallery_grouped[4] is not None)
        return self.gallery_pm8 is not None

    def save(self, path: str) -> None:
        from hashgan_tpu_torch.utils.checkpoint import save_gallery

        save_gallery(path, self.canonical_packed(), self.labels, self.bits)

    @classmethod
    def load(cls, path: str, device: torch.device | str | None = None,
             mesh: Optional[Mesh] = None) -> "PackedGallery":
        """A saved gallery, rebuilt on ``device`` or over ``mesh``."""
        from hashgan_tpu_torch.utils.checkpoint import load_gallery

        packed, labels, bits = load_gallery(path)
        return build_gallery_from_packed(packed, labels, bits, device=device,
                                         mesh=mesh)


def build_gallery_from_packed_device(
    packed: torch.Tensor, labels: np.ndarray, bits: int,
    build_pm8: bool = False, groups: int = GROUPS,
    col_multiple: int = COL_MULTIPLE,
) -> PackedGallery:
    """(N, W) int32 packed codes on a device -> gallery on that device; every
    layout is a reshape/transpose there, so updates never copy the gallery
    through the host. Past ``groupmin_capacity_ok`` the gallery takes the
    slabbed layout (no pm8 copy, as in the reference)."""
    n, w = packed.shape
    packed = packed.to(torch.int32)
    labels = np.asarray(labels)
    if not groupmin_capacity_ok(n, w, groups, col_multiple):
        return PackedGallery(
            packed_canonical=packed, labels=labels, n=n, bits=bits,
            gallery_slabbed=build_slabbed_layout(packed, groups, col_multiple))
    canon = pad_to_layout(packed, groups, col_multiple)
    grouped = to_grouped_layout(canon, groups, col_multiple)
    bg = to_group_major(canon, groups, col_multiple)            # (C, L, W)
    pm8 = None
    if build_pm8 and 32 * w * canon.shape[0] <= PM8_BUDGET_BYTES:
        pm8 = grouped_to_pm8(grouped, pm8_column_block(grouped.shape[2]))
    return PackedGallery(
        packed_canonical=canon, labels=labels, n=n, bits=bits,
        gallery_grouped=grouped, canon_bg=bg.view(bg.shape[0], -1),
        gallery_pm8=pm8,
    )


def build_gallery_from_packed(
    packed, labels: np.ndarray, bits: int,
    device: torch.device | str | None = None, mesh: Optional[Mesh] = None,
    build_pm8: bool = False,
) -> PackedGallery:
    """(N, W) uint32 (or int32) host packed codes, or an int32 tensor of
    them on any device -> gallery on ``device``, or over ``mesh`` (whose
    first device is then the gallery's)."""
    device = _home(device, mesh)
    words = (packed.to(torch.int32) if isinstance(packed, torch.Tensor) else
             torch.from_numpy(np.ascontiguousarray(packed).view(np.int32)))
    if mesh is not None and mesh.size > 1:
        return _build_sharded(words, labels, bits, mesh, build_pm8)
    gal = build_gallery_from_packed_device(words.to(device), labels, bits,
                                           build_pm8=build_pm8)
    gal.mesh = mesh
    return gal


def build_gallery(codes: torch.Tensor, labels: np.ndarray, bits: int,
                  mesh: Optional[Mesh] = None,
                  build_pm8: bool = False) -> PackedGallery:
    """(N, bits) continuous codes -> gallery on the codes' device (sign +
    bitpack there: the ``pack`` kernel on a GPU), or over ``mesh``, split
    from the packed codes without a copy through the host."""
    packed = pack_codes(codes)
    if mesh is None:
        return build_gallery_from_packed_device(packed, labels, bits,
                                                build_pm8=build_pm8)
    _home(None, mesh)
    if mesh.size > 1:
        return _build_sharded(packed, labels, bits, mesh, build_pm8)
    gal = build_gallery_from_packed_device(packed.to(mesh.devices[0]), labels,
                                           bits, build_pm8=build_pm8)
    gal.mesh = mesh
    return gal


def _home(device, mesh: Optional[Mesh]) -> torch.device:
    """The gallery's device: ``device``, or the mesh's first one."""
    if mesh is None:
        if device is None:
            raise ValueError("a gallery needs a device or a mesh")
        return torch.device(device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    if device is not None and Mesh([device]).devices[0] != mesh.devices[0]:
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{mesh.devices[0]}")
    return mesh.devices[0]


def _build_sharded(packed: torch.Tensor, labels: np.ndarray, bits: int,
                   mesh: Mesh, build_pm8: bool) -> PackedGallery:
    """The reference's mesh branch (``gallery.py:308-390``): the scan layout
    padded to a multiple of 8 * mesh size and split over the mesh, and the
    per-shard grouped layouts where one shard's share fits the grouped
    engines' key space (past it the gallery serves through the sharded sort
    engine), with the pm8 copies within ``PM8_BUDGET_BYTES`` a shard."""
    n, w = packed.shape
    nd = mesh.size
    n_pad = pad_to_multiple(n, nd * 8)
    padded = (torch.cat([packed, packed.new_zeros((n_pad - n, w))])
              if n_pad != n else packed)
    gallery_t = tuple(g.t().contiguous() for g in _shards(mesh, padded, 0))
    grouped = None
    if groupmin_capacity_ok(-(-n // nd), w):
        g, canon, valids, bg, n_loc = shard_grouped_gallery(
            mesh, packed, GROUPS, COL_MULTIPLE)
        pm8 = None
        if build_pm8 and 32 * w * n_loc <= PM8_BUDGET_BYTES:
            pm8 = shard_pm8_gallery(mesh, g, pm8_column_block(g[0].shape[2]))
        grouped = (g, canon, valids, bg, pm8)
    return PackedGallery(packed_canonical=None, labels=np.asarray(labels),
                         n=n, bits=bits, gallery_grouped=grouped, mesh=mesh,
                         gallery_t=gallery_t)
