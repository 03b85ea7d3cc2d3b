"""Numpy oracles for the packed-code ops (port of
``hashgan_tpu/ops/ref_numpy.py``, plain numpy, kept as the port's own copy).

These are the in-tree ground truth against which the kernels and their
plain twins are held.

Bit layout contract (shared by every implementation in the repository):
  - codes are float/int arrays of shape (N, b); bit i is 1 iff
    code[:, i] > 0 (strict: a code of 0 packs to 0).
  - the packed layout is uint32, shape (N, ceil(b/32)); word w holds bits
    [32*w, 32*w+31], bit j of word w = code bit 32*w + j at weight 1 << j
    (little-endian within a word). The port keeps the same words as int32
    tensors read as bits (``.view(np.uint32)`` gives these arrays).
"""

from __future__ import annotations

import numpy as np


def pack_codes_np(codes: np.ndarray) -> np.ndarray:
    """(N, b) real codes -> (N, ceil(b/32)) uint32 packed bits (bit = code > 0).

    Non-multiple-of-32 widths are padded with always-0 bits (distance-neutral).
    """
    n, b = codes.shape
    b_pad = ((b + 31) // 32) * 32
    if b_pad != b:
        codes = np.pad(codes, ((0, 0), (0, b_pad - b)), constant_values=-1.0)
        b = b_pad
    bits = (codes > 0).astype(np.uint32).reshape(n, b // 32, 32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, None, :]
    return (bits * weights).sum(axis=2).astype(np.uint32)


def unpack_codes_np(packed: np.ndarray, bits: int) -> np.ndarray:
    """(N, ceil(b/32)) uint32 -> (N, b) float32 in {-1, +1}."""
    n, w = packed.shape
    if w * 32 < bits:
        raise ValueError(f"packed width {w} too small for bits={bits}")
    shifts = np.arange(32, dtype=np.uint32)[None, None, :]
    b = (packed[:, :, None] >> shifts) & np.uint32(1)
    return (b.reshape(n, w * 32)[:, :bits].astype(np.float32) * 2.0) - 1.0


def _popcount32_np(x: np.ndarray) -> np.ndarray:
    """Vectorized popcount for uint32 arrays."""
    x = x.astype(np.uint32)
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int32)


def hamming_distance_np(packed_q: np.ndarray, packed_g: np.ndarray) -> np.ndarray:
    """All-pairs Hamming distance between packed code sets.

    (Q, W) x (N, W) -> (Q, N) int32. Chunked over queries to bound memory.
    """
    q, w = packed_q.shape
    out = np.zeros((q, packed_g.shape[0]), dtype=np.int32)
    chunk = max(1, (1 << 24) // max(1, packed_g.shape[0]))
    for lo in range(0, q, chunk):
        hi = min(lo + chunk, q)
        x = packed_q[lo:hi, None, :] ^ packed_g[None, :, :]
        out[lo:hi] = _popcount32_np(x).sum(axis=2)
    return out
