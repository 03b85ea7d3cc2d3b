"""The reference's list files (port of ``hashgan_tpu/data/lists.py``):
one line per image, ``<image path> <b0> <b1> ...``, the label as 0/1 bits
(one-hot for CIFAR-10, multi-hot for NUS-WIDE)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def parse_list_file(path: str) -> Tuple[List[str], np.ndarray]:
    """(paths, labels) of a list file; labels (N, n_classes) float32 0/1,
    shorter rows padded with zeros to the widest."""
    paths: List[str] = []
    rows: List[List[float]] = []
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            parts = line.split()
            paths.append(parts[0])
            rows.append([float(x) for x in parts[1:]])
    if not rows:
        return paths, np.zeros((0, 0), dtype=np.float32)
    width = max(len(r) for r in rows)
    labels = np.zeros((len(rows), width), dtype=np.float32)
    for i, r in enumerate(rows):
        labels[i, :len(r)] = r
    return paths, labels


def write_list_file(path: str, image_paths: List[str],
                    labels: np.ndarray) -> None:
    with open(path, "w") as f:
        for p, row in zip(image_paths, np.asarray(labels)):
            bits = " ".join(str(int(round(float(x)))) for x in row)
            f.write(f"{p} {bits}\n")
