"""Device-resident packed Hamming gallery: build, update, persist, query.

Port of ``hashgan_tpu/index/gallery.py`` for one device. A gallery holds
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
``packed_canonical`` at the first call that needs it. A sharded gallery (``mesh``) is not ported
and raises.
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
from hashgan_tpu_torch.ops.mxu_large_k import grouped_topk
from hashgan_tpu_torch.ops.mxu_scan import (
    check_mode,
    grouped_to_pm8,
    pm8_column_block,
    to_group_major,
)
from hashgan_tpu_torch.ops.pack import pack_codes
from hashgan_tpu_torch.ops.slab_scan import build_slabbed_layout, mxu_topk_slabbed

GROUPS = 128        # L: items per column group
COL_MULTIPLE = 256  # C is padded to a multiple of this
LARGE_K_MAX = 8192  # deepest k of the subgroup engine (reference default)
PM8_BUDGET_BYTES = 512 * 1024 * 1024  # device bytes for the +-1 int8 copy


@dataclasses.dataclass
class PackedGallery:
    """labels: (N, K) host array; n: true item count; bits: logical width.
    Entries returned with index >= n are padding sentinels. Exactly one of
    (``gallery_grouped`` with ``canon_bg``) and ``gallery_slabbed`` is set:
    ``gallery_slabbed`` = (gallery_gs, canon_bgs, valids, slab_items)."""

    packed_canonical: torch.Tensor   # (n_layout >= n, W) int32
    labels: np.ndarray
    n: int
    bits: int
    gallery_grouped: Optional[torch.Tensor] = None   # (W, L, C) int32
    canon_bg: Optional[torch.Tensor] = None          # (C, L*W) int32
    gallery_pm8: Optional[torch.Tensor] = None       # (B, NB, L, cb) int8
    gallery_slabbed: Optional[tuple] = None
    _scan_t: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def words(self) -> int:
        return self.packed_canonical.shape[1]

    @property
    def device(self) -> torch.device:
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
        queries stream through the sort engine."""
        check_mode(mode)
        packed_q = packed_q.to(self.device)
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

    def canonical_packed(self) -> np.ndarray:
        """(n, W) uint32 canonical packed codes (host copy)."""
        return self.packed_canonical[: self.n].cpu().numpy().view(np.uint32)

    def extend(self, codes, labels: np.ndarray) -> "PackedGallery":
        """Append items; returns a NEW gallery. New items take ids
        n..n+m-1 and existing ids are stable. The layouts (the pm8 copy
        too, if the gallery has one) are rebuilt on the device, and only
        the new codes cross to it."""
        codes = torch.as_tensor(codes, dtype=torch.float32).to(self.device)
        packed_new = pack_codes(codes)
        labels_all = np.concatenate(
            [self.labels[: self.n], np.asarray(labels)], axis=0)
        packed = torch.cat([self.packed_canonical[: self.n], packed_new])
        return build_gallery_from_packed_device(
            packed, labels_all, self.bits, build_pm8=self._has_pm8())

    def remove(self, ids) -> Tuple["PackedGallery", np.ndarray]:
        """Delete items; returns (new gallery, id_map) with
        ``id_map[new_id] = old_id``. Ids stay contiguous (the tie order ranks
        by database index, so holes would change rankings)."""
        mask = np.ones(self.n, dtype=bool)
        mask[np.asarray(ids)] = False
        keep = np.flatnonzero(mask)
        packed = self.packed_canonical[: self.n][
            torch.from_numpy(keep).to(self.device)]
        gal = build_gallery_from_packed_device(
            packed, self.labels[: self.n][keep], self.bits,
            build_pm8=self._has_pm8())
        return gal, keep

    def _has_pm8(self) -> bool:
        """True if this gallery carries the opt-in +-1 scan copy (extend and
        remove keep it)."""
        return self.gallery_pm8 is not None

    def save(self, path: str) -> None:
        from hashgan_tpu_torch.utils.checkpoint import save_gallery

        save_gallery(path, self.canonical_packed(), self.labels, self.bits)

    @classmethod
    def load(cls, path: str, device: torch.device | str) -> "PackedGallery":
        from hashgan_tpu_torch.utils.checkpoint import load_gallery

        packed, labels, bits = load_gallery(path)
        return build_gallery_from_packed(packed, labels, bits, device=device)


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
    packed: np.ndarray, labels: np.ndarray, bits: int,
    device: torch.device | str, mesh=None, build_pm8: bool = False,
) -> PackedGallery:
    """(N, W) uint32 (or int32) host packed codes -> gallery on ``device``."""
    if mesh is not None:
        raise NotImplementedError(
            "a sharded gallery (mesh=...) is not ported yet (see ROADMAP.md)")
    words = np.ascontiguousarray(packed).view(np.int32)
    return build_gallery_from_packed_device(
        torch.from_numpy(words).to(device), labels, bits, build_pm8=build_pm8)


def build_gallery(codes: torch.Tensor, labels: np.ndarray, bits: int,
                  mesh=None, build_pm8: bool = False) -> PackedGallery:
    """(N, bits) continuous codes -> gallery on the codes' device (sign +
    bitpack there: the ``pack`` kernel on a GPU)."""
    if mesh is not None:
        raise NotImplementedError(
            "a sharded gallery (mesh=...) is not ported yet (see ROADMAP.md)")
    return build_gallery_from_packed_device(pack_codes(codes), labels, bits,
                                            build_pm8=build_pm8)
