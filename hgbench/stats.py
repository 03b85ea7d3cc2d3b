"""The arithmetic of the metrics: rates, rooflines.

Peaks are NVIDIA's published dense rates of one H100 SXM at its 700 W
limit (the data sheet); a run prints the card's power limit beside them.
"""

from __future__ import annotations

from typing import Optional

INT8_OPS_PER_S = 1979e12     # int8 tensor cores, dense
BF16_FLOPS_PER_S = 989e12    # bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12


def rate(count: float, seconds: float) -> float:
    """Work over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def roofline_pct(ops: float, ops_per_s: float, bytes_moved: float,
                 seconds: float) -> Optional[float]:
    """The least time the card could take for the work (the larger of the
    operations over their peak and the bytes over the memory rate) as a
    share of the time it took, in %. None where nothing ran."""
    if seconds <= 0 or ops <= 0:
        return None
    least = max(ops / ops_per_s, bytes_moved / HBM_BYTES_PER_S)
    return 100.0 * least / seconds
