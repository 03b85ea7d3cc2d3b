"""Device-resident packed Hamming gallery: build, update, persist, query.

Port of ``hashgan_tpu/index/gallery.py`` for one device and the grouped
layout. A gallery holds three layouts of the same int32 words, all built on
its device by reshapes and transposes:

- ``packed_canonical`` (L*C, W): items in id order, zero-padded to the layout;
- ``gallery_grouped`` (W, L, C): what the full-key scan reads;
- ``canon_bg`` (C, L*W): group-major rows, what the rescan reads.

What the port does not cover raises instead of switching engines: galleries
past ``groupmin_capacity_ok`` (the reference's slabbed engine), ``k > 256``
(its large-k engine), ``mode="approx"``, a ``mesh``, ``repair`` or
``gallery_pm8``. See ROADMAP.md for when those come.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from hashgan_tpu_torch.ops.groupmin import (
    groupmin_capacity_ok,
    pad_to_layout,
    to_grouped_layout,
)
from hashgan_tpu_torch.ops.mxu_scan import mxu_topk, to_group_major
from hashgan_tpu_torch.ops.pack import pack_codes

GROUPS = 128        # L: items per column group
COL_MULTIPLE = 256  # C is padded to a multiple of this
MAX_K = 256         # deepest k of the winner-column engine


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (see ROADMAP.md)")


@dataclasses.dataclass
class PackedGallery:
    """labels: (N, K) host array; n: true item count; bits: logical width.
    Entries returned with index >= n are padding sentinels."""

    packed_canonical: torch.Tensor   # (L*C, W) int32
    gallery_grouped: torch.Tensor    # (W, L, C) int32
    canon_bg: torch.Tensor           # (C, L*W) int32
    labels: np.ndarray
    n: int
    bits: int

    @property
    def words(self) -> int:
        return self.packed_canonical.shape[1]

    @property
    def device(self) -> torch.device:
        return self.packed_canonical.device

    def topk(self, packed_q: torch.Tensor, k: int = 100, mode: str = "exact",
             repair: Optional[int] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k of (Q, W) int32 packed queries: (distances, indices),
        each (Q, min(k, L*C)) int32 on the gallery's device."""
        if repair is not None:
            raise _unsupported("the group-min/min2 engine (repair=...)")
        if k > MAX_K:
            raise _unsupported(f"k={k} > {MAX_K} (the large-k engine)")
        if mode != "exact":
            raise _unsupported(
                f"mode={mode!r} (approx top-k, which needs its own recall "
                "contract)")
        return mxu_topk(packed_q.to(self.device), self.gallery_grouped,
                        self.canon_bg, valid_n=self.n, k=k)

    def canonical_packed(self) -> np.ndarray:
        """(n, W) uint32 canonical packed codes (host copy)."""
        return self.packed_canonical[: self.n].cpu().numpy().view(np.uint32)

    def extend(self, codes, labels: np.ndarray) -> "PackedGallery":
        """Append items; returns a NEW gallery. New items take ids
        n..n+m-1 and existing ids are stable. The layouts are rebuilt on
        the device, and only the new codes cross to it."""
        codes = torch.as_tensor(codes, dtype=torch.float32).to(self.device)
        packed_new = pack_codes(codes)
        labels_all = np.concatenate(
            [self.labels[: self.n], np.asarray(labels)], axis=0)
        packed = torch.cat([self.packed_canonical[: self.n], packed_new])
        return build_gallery_from_packed_device(packed, labels_all, self.bits)

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
            packed, self.labels[: self.n][keep], self.bits)
        return gal, keep

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
    groups: int = GROUPS, col_multiple: int = COL_MULTIPLE,
) -> PackedGallery:
    """(N, W) int32 packed codes on a device -> gallery on that device; every
    layout is a reshape/transpose there, so updates never copy the gallery
    through the host."""
    n, w = packed.shape
    if not groupmin_capacity_ok(n, w, groups, col_multiple):
        raise _unsupported(
            f"a {n}-item {32 * w}-bit gallery past the grouped engine's int32 "
            "key space (the slabbed engine)")
    canon = pad_to_layout(packed.to(torch.int32), groups, col_multiple)
    bg = to_group_major(canon, groups, col_multiple)            # (C, L, W)
    return PackedGallery(
        packed_canonical=canon,
        gallery_grouped=to_grouped_layout(canon, groups, col_multiple),
        canon_bg=bg.view(bg.shape[0], -1),
        labels=np.asarray(labels), n=n, bits=bits,
    )


def build_gallery_from_packed(
    packed: np.ndarray, labels: np.ndarray, bits: int,
    device: torch.device | str, mesh=None, build_pm8: bool = False,
) -> PackedGallery:
    """(N, W) uint32 (or int32) host packed codes -> gallery on ``device``."""
    if mesh is not None:
        raise _unsupported("a sharded gallery (mesh=...)")
    if build_pm8:
        raise _unsupported("the +-1 int8 scan copy (build_pm8=True)")
    words = np.ascontiguousarray(packed).view(np.int32)
    return build_gallery_from_packed_device(
        torch.from_numpy(words).to(device), labels, bits)


def build_gallery(codes: torch.Tensor, labels: np.ndarray, bits: int,
                  mesh=None, build_pm8: bool = False) -> PackedGallery:
    """(N, bits) continuous codes -> gallery on the codes' device (sign +
    bitpack there: the ``pack`` kernel on a GPU)."""
    if mesh is not None:
        raise _unsupported("a sharded gallery (mesh=...)")
    if build_pm8:
        raise _unsupported("the +-1 int8 scan copy (build_pm8=True)")
    return build_gallery_from_packed_device(pack_codes(codes), labels, bits)
