"""Checkpoints and gallery artifacts (port of
``hashgan_tpu/utils/checkpoint.py`` and of the data-provenance record of
``hashgan_tpu/train/loop.py:709-769``).

``CheckpointManager`` keeps ``torch.save`` files of a state dict (the
encoder's ``state_dict``, the optimiser's and the schedule's, and the step)
under ``<workdir>/checkpoints``, with ``max_to_keep`` retention, and loads
them with ``torch.load(weights_only=True)``. Batches and augmentation draws
are functions of (seed, step), so a restored run continues bit-exactly.

The gallery npz schema is the reference's (``packed`` uint32, ``labels``,
``bits``), so a gallery saved by either package loads in the other.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional

import numpy as np
import torch

_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")
PROVENANCE_FILE = "data_provenance.json"


class CheckpointManager:
    def __init__(self, workdir: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.path.join(workdir, "checkpoints"))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _CKPT.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` for ``step`` (through a temporary file and a
        rename, so a crash never leaves a torn checkpoint), then delete all
        but the newest ``max_to_keep``."""
        tmp = f"{self._path(step)}.tmp{os.getpid()}"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None) -> Any:
        """The state saved at ``step`` (default: the latest), on the CPU;
        None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)


def write_provenance(workdir: str, provenance: str) -> None:
    with open(os.path.join(workdir, PROVENANCE_FILE), "w") as f:
        json.dump({"provenance": provenance}, f)


def check_provenance(workdir: str, provenance: str) -> None:
    """Raise when the checkpoints of ``workdir`` were trained on other data
    than ``provenance`` names; adopt it when no record exists."""
    try:
        with open(os.path.join(workdir, PROVENANCE_FILE)) as f:
            saved = json.load(f)["provenance"]
    except (OSError, ValueError, KeyError):
        write_provenance(workdir, provenance)
        return
    if saved != provenance:
        raise RuntimeError(
            "checkpoint data-provenance mismatch: this run was trained on "
            f"{saved!r} but the current config would feed {provenance!r}. "
            "Resuming would change the training data mid-run; start a fresh "
            "workdir or restore the original data settings.")


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
