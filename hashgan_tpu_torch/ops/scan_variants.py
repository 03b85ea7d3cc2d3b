"""The scan's tensor-core variant (port of ``scripts/bench_scan_variants.py``'s
``fullkey_scan_bf16``).

The reference's experiment takes the full-key scan's +-1 product on the
matrix unit with a 16-bit accumulator. The port's counterpart,
``csrc/fullkey_scan_mma.cu``, runs it on Hopper's tensor cores as
``mma.sync`` with f16 operands and an f16 accumulator (the card gives bf16
operands only a float32 accumulator), exact because every partial sum is an
integer of magnitude at most B <= 256, on the walk that kernel 2 runs with
int8 operands (``csrc/grouped_scan.cuh``). It computes the same function as
the exact scan of ``ops/mxu_scan.py`` (kernel 2), with kernel 2's interface,
so a caller swaps one for the other in one line; its plain version is kernel
2's, ``fullkey_scan_keys_torch``.
"""

from __future__ import annotations

import torch

from hashgan_tpu_torch.ops import _build
from hashgan_tpu_torch.ops.mxu_scan import fullkey_scan_keys_torch


def max_queries(words: int) -> int:
    """The kernel's grid: 65,535 block rows of 256 queries at <= 4 words, of
    128 above."""
    return 65535 * (256 if words <= 4 else 128)


def fullkey_scan_bf16(packed_q: torch.Tensor, gallery_g: torch.Tensor,
                      valid_n: int, stride: int) -> torch.Tensor:
    """(Q, W) packed queries x (W, L, C) grouped gallery -> (Q, C) int32 full
    composite keys ``d * stride + s * C + c`` (INT32_MAX for a column with no
    valid item), as ``mxu_scan.fullkey_scan_keys``. It takes the packed
    queries and ``valid_n`` where the reference takes +-1 queries and a key
    base. CUDA tensors launch ``csrc/fullkey_scan_mma.cu``; CPU tensors run
    ``fullkey_scan_keys_torch``."""
    w, L, c = gallery_g.shape
    _build.check_words(packed_q, w)
    if gallery_g.device.type == "cpu":
        return fullkey_scan_keys_torch(packed_q, gallery_g, valid_n, stride)
    if L > 65536:
        raise ValueError(f"the scan kernel takes at most 65536 groups, got {L}")
    _build.require_cuda_tensor(packed_q, "packed_q", torch.int32, 2)
    _build.require_cuda_tensor(gallery_g, "gallery_g", torch.int32, 3)
    q = packed_q.shape[0]
    _build.check_queries(q, max_queries(w))
    full = torch.empty((q, c), dtype=torch.int32, device=gallery_g.device)
    if full.numel():
        _build.KERNELS.launch(
            "fullkey_scan_mma", gallery_g.device, packed_q.data_ptr(),
            gallery_g.data_ptr(), full.data_ptr(), q, w, L, c, int(valid_n),
            stride)
    return full
