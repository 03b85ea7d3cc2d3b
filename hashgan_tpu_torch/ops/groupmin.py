"""Grouped scan layout helpers (port of ``hashgan_tpu/ops/groupmin.py:39-94``).

The gallery lives in a grouped scan layout (W, L, C): item ``n = s * C + c``
is word-sliced at ``[w, s, c]``, so a column c holds the group of L items
the exact scan takes one minimum over. The group-min kernel of the
reference (``_groupmin_kernel``) is not part of this port yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1

# Padding addend base of the reference's min2 engine; it also sets the
# capacity limit below, so the port accepts exactly the galleries the
# reference serves with its grouped engines.
PAD_BASE = 1_000_000_000


def layout_columns(n: int, groups: int = 128, col_multiple: int = 256) -> int:
    """Column count C of the grouped layout for n items (a multiple of
    ``col_multiple``, so ``L * C >= n``)."""
    return -(-n // (groups * col_multiple)) * col_multiple


def pad_to_layout(packed: torch.Tensor, groups: int = 128,
                  col_multiple: int = 256) -> torch.Tensor:
    """(N, W) canonical words -> (L*C, W) with all-zero padding items."""
    n, w = packed.shape
    n_pad = groups * layout_columns(n, groups, col_multiple)
    if n_pad == n:
        return packed
    return torch.cat([packed, packed.new_zeros((n_pad - n, w))], dim=0)


def to_grouped_layout(packed: torch.Tensor, groups: int = 128,
                      col_multiple: int = 256) -> torch.Tensor:
    """(N, W) canonical packed codes -> (W, L, C) grouped scan layout.

    Padding items occupy the tail indices (>= N); the scan masks them by
    ``valid_n``. Runs on the tensor's own device."""
    w = packed.shape[1]
    c = layout_columns(packed.shape[0], groups, col_multiple)
    cube = pad_to_layout(packed, groups, col_multiple).view(groups, c, w)
    return cube.permute(2, 0, 1).contiguous()


def groupmin_capacity_ok(
    n_total: int, words: int, groups: int = 128, col_multiple: int = 256,
    pad_base: int = PAD_BASE,
) -> bool:
    """Whether an n-item gallery fits the grouped engines' int32 key space
    (~7.7M items at 128 bits, ~15M at 64, ~30M at 32). ``n_total`` is padded
    to the layout unit before the check. Past it the reference switches to
    its slabbed engine, which this port does not have yet."""
    unit = groups * col_multiple
    n_pad = -(-max(n_total, 1) // unit) * unit
    stride = n_pad + 1
    return (32 * words + 1) * stride + n_pad < pad_base
