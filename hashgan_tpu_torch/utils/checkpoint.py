"""Gallery artifacts (port of ``hashgan_tpu/utils/checkpoint.py:52-65``).

The npz schema is the reference's (``packed`` uint32, ``labels``, ``bits``),
so a gallery saved by either package loads in the other. Encoder and
training checkpoints come with the stage-II slice (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np


def save_gallery(path: str, packed: np.ndarray, labels: np.ndarray,
                 bits: int) -> None:
    """Persist a packed gallery; int32 words are stored as uint32."""
    packed = np.asarray(packed)
    if packed.dtype == np.int32:
        packed = packed.view(np.uint32)
    np.savez(path, packed=packed, labels=np.asarray(labels),
             bits=np.int32(bits))


def load_gallery(path: str, mmap: bool = False):
    """-> (packed uint32 (N, W), labels, bits)."""
    z = np.load(path, mmap_mode="r" if mmap else None)
    return z["packed"], z["labels"], int(z["bits"])
