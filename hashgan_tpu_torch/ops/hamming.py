"""XOR-popcount Hamming distances over packed codes, and the exact slabbed
top-k (port of ``hashgan_tpu/ops/hamming.py``).

The gallery is read in the reference's **scan layout** (W, N): word w of
every item is one row, so the kernel's loads along N are contiguous.

- ``hamming_distance_torch``: the plain PyTorch version, XOR plus
  ``ops/pack.py::popcount32`` (any device).
- ``hamming_distance_t``: the CUDA kernel ``csrc/hamming.cu`` for CUDA
  tensors, the plain version for CPU tensors. It takes a column slice of a
  larger scan-layout gallery as it is (the row stride is passed through).
- ``hamming_distance``: the same on a canonical (N, W) gallery.
- ``hamming_scan_topk``: exact streaming top-k over gallery slabs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hashgan_tpu_torch.ops import _build
from hashgan_tpu_torch.ops.pack import popcount32

MAX_QUERIES = 65535 * 32  # the kernel's grid: 32 queries per block row


def hamming_distance_torch(packed_q: torch.Tensor,
                           packed_g: torch.Tensor) -> torch.Tensor:
    """(Q, W) x canonical (N, W) int32 words -> (Q, N) int32 distances.
    Chunked over queries so the (chunk, N, W) intermediates stay near 2**26
    elements."""
    q, w = packed_q.shape
    n = packed_g.shape[0]
    out = torch.empty((q, n), dtype=torch.int32, device=packed_g.device)
    chunk = max(1, (1 << 26) // max(1, n * w))
    for lo in range(0, q, chunk):
        x = packed_q[lo:lo + chunk, None, :] ^ packed_g[None, :, :]
        out[lo:lo + chunk] = popcount32(x).sum(dim=2, dtype=torch.int32)
    return out


def hamming_distance_t(packed_q: torch.Tensor,
                       gallery_t: torch.Tensor) -> torch.Tensor:
    """(Q, W) packed queries x (W, N) scan-layout gallery -> (Q, N) int32.

    CUDA tensors launch ``csrc/hamming.cu``; the gallery may be a column
    slice (unit column stride, any row stride). CPU tensors run
    ``hamming_distance_torch``."""
    if packed_q.dim() != 2 or gallery_t.dim() != 2:
        raise ValueError("expected (Q, W) queries and a (W, N) gallery, got "
                         f"{tuple(packed_q.shape)} and {tuple(gallery_t.shape)}")
    q, w = packed_q.shape
    if gallery_t.shape[0] != w:
        raise ValueError(f"queries have {w} words, gallery "
                         f"{gallery_t.shape[0]}")
    if gallery_t.device.type == "cpu":
        return hamming_distance_torch(packed_q, gallery_t.t())
    n = gallery_t.shape[1]
    _build.require_cuda_tensor(packed_q, "packed_q", torch.int32, 2)
    if gallery_t.device.type != "cuda" or gallery_t.dtype != torch.int32:
        raise ValueError("gallery_t must be a CUDA int32 tensor, got "
                         f"{gallery_t.dtype} on {gallery_t.device}")
    if n > 1 and gallery_t.stride(1) != 1:
        raise ValueError("gallery_t must have unit column stride (a (W, N) "
                         "row-major gallery or a column slice of one)")
    if q > MAX_QUERIES:
        raise ValueError(f"the kernel takes at most {MAX_QUERIES} queries "
                         f"per call, got {q}")
    out = torch.empty((q, n), dtype=torch.int32, device=gallery_t.device)
    if out.numel():
        _build.KERNELS.launch("hamming", gallery_t.device,
                              packed_q.data_ptr(), gallery_t.data_ptr(),
                              out.data_ptr(), q, n, w, gallery_t.stride(0))
    return out


def hamming_distance(packed_q: torch.Tensor,
                     packed_g: torch.Tensor) -> torch.Tensor:
    """All-pairs distances against a canonical (N, W) gallery (the
    reference's ``hamming_distance``): one transpose to the scan layout,
    then ``hamming_distance_t``."""
    return hamming_distance_t(packed_q, packed_g.t().contiguous())


def hamming_scan_topk(packed_q: torch.Tensor, gallery_t: torch.Tensor,
                      k: int = 100, slab: int = 1 << 17,
                      valid_n: Optional[int] = None, mode: str = "exact",
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k of (Q, W) queries over a (W, N) scan-layout gallery:
    (distances (Q, k) int32 ascending, indices (Q, k) int32).

    Ties break toward the lower database index, as the numpy oracle's
    stable argsort does. Items with index >= ``valid_n`` are padding: they
    get the sentinel distance 32 * W + 1 and sort after every real item;
    where fewer than k items are valid, the list ends in the padding items
    in index order, then (sentinel, N) entries, as the reference's
    composite-key branch gives it.

    Each slab's candidates merge into the running list on the int64 key
    ``d * (n_pad + 1) + idx``. The key decodes to exactly one (d, idx), so
    equal keys are equal entries, ``torch.topk``'s tie order cannot change
    a result, and the key cannot overflow at any gallery size (the
    reference falls back to a distance-only merge past int32). Columns that
    pad the last slab are never scanned: their keys would sort after the
    k initial (sentinel, N) entries. ``mode="approx"`` (the reference's
    ``lax.approx_min_k`` selection) is not ported."""
    if mode != "exact":
        raise NotImplementedError(
            f"mode={mode!r} (approx top-k selection) is not ported yet "
            "(ROADMAP.md)")
    q, w = packed_q.shape
    n = gallery_t.shape[1]
    valid_n = n if valid_n is None else int(valid_n)
    sentinel = 32 * w + 1
    slab = max(1, min(slab, n))
    n_pad = -(-n // slab) * slab
    stride = n_pad + 1
    dev = gallery_t.device
    best = torch.full((q, k), sentinel * stride + n, dtype=torch.int64,
                      device=dev)
    for lo in range(0, n, slab):
        hi = min(lo + slab, n)
        d = hamming_distance_t(packed_q, gallery_t[:, lo:hi]).to(torch.int64)
        idx = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        key = torch.where(idx < valid_n, d, sentinel) * stride + idx
        best, _ = torch.topk(torch.cat([best, key], dim=1), k, dim=1,
                             largest=False, sorted=True)
    return ((best // stride).to(torch.int32),
            (best % stride).to(torch.int32))
