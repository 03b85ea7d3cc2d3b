"""Sign-quantization fused with bit-packing (port of ``hashgan_tpu/ops/pack.py``).

Layout contract (``hashgan_tpu/ops/ref_numpy.py``): bit i of word w is
``code[32w + i] > 0``; widths that are not a multiple of 32 pad with
always-0 bits, which leave every Hamming distance unchanged.

Packed words are int32 tensors read as bits (torch's uint32 support is
thin); at a numpy boundary ``.view(np.uint32)`` / ``.view(np.int32)``
converts without a copy.

- ``pack_codes_torch``: the plain PyTorch version (any device).
- ``pack_codes``: the CUDA kernel ``csrc/pack.cu`` for CUDA tensors, the
  plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from hashgan_tpu_torch.ops import _build


def words_for(bits: int) -> int:
    return (bits + 31) // 32


def _pad_bit_columns(codes: torch.Tensor) -> torch.Tensor:
    """Pad the bit axis to a multiple of 32 with -1 columns (pack to 0)."""
    b = codes.shape[1]
    b_pad = words_for(b) * 32
    if b_pad != b:
        codes = torch.nn.functional.pad(codes, (0, b_pad - b), value=-1.0)
    return codes


def pack_codes_torch(codes: torch.Tensor) -> torch.Tensor:
    """(N, b) real codes -> (N, ceil(b/32)) int32 words (plain version)."""
    codes = _pad_bit_columns(codes)
    n, b = codes.shape
    bits = (codes > 0).to(torch.int64).view(n, b // 32, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=codes.device)
    # Words are disjoint bit sets, so the sum is exact; values >= 2^31 wrap
    # to the negative int32 with the same bit pattern.
    words = (bits << shifts).sum(dim=2)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(N, b) real codes -> (N, ceil(b/32)) int32 words.

    CUDA tensors go through the ``pack`` kernel (float32; other float dtypes
    are converted first), CPU tensors through ``pack_codes_torch``."""
    if codes.dim() != 2:
        raise ValueError(f"codes must be (N, bits), got {tuple(codes.shape)}")
    if codes.device.type == "cpu":
        return pack_codes_torch(codes)
    codes = codes.to(torch.float32).contiguous()
    _build.require_cuda_tensor(codes, "codes", torch.float32, 2)
    n, bits = codes.shape
    out = torch.empty((n, words_for(bits)), dtype=torch.int32,
                      device=codes.device)
    if out.numel():
        _build.KERNELS.launch("pack", codes.device, codes.data_ptr(),
                              out.data_ptr(), n, bits, out.shape[1])
    return out


def unpack_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(N, ceil(b/32)) int32 words -> (N, b) float32 in {-1, +1}."""
    n, w = packed.shape
    if w * 32 < bits:
        raise ValueError(f"packed width {w} too small for bits={bits}")
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    b = (packed[:, :, None] >> shifts) & 1  # arithmetic shift, then bit 0
    return b.reshape(n, w * 32)[:, :bits].to(torch.float32) * 2.0 - 1.0


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words read as bits -> int32 (0..32).

    Runs the SWAR reduction in int64 on the zero-extended word, so no step
    can overflow or see a sign bit."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F).to(torch.int32)
