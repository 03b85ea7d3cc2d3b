"""Structured metrics logging (port of ``hashgan_tpu/utils/logging.py``).

Scalars accumulate in memory; ``flush`` appends their means as one JSON line
to ``<workdir>/metrics.jsonl`` in the reference's schema (``step``,
``time`` and one key per metric), prints them, and renders per-metric
curves when matplotlib is importable.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, workdir: str, plot: bool = True, quiet: bool = False):
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.jsonl_path = os.path.join(workdir, "metrics.jsonl")
        self.quiet = quiet
        self.plot = plot
        self._pending: Dict[str, list] = defaultdict(list)
        self._history: Dict[str, list] = defaultdict(list)  # (step, mean)
        self._last_step = 0
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        """Queue scalars (floats or 0-dim tensors: ``float`` reads them)."""
        for k, v in metrics.items():
            self._pending[k].append(float(v))
        self._last_step = step

    def flush(self, step: Optional[int] = None) -> Dict[str, float]:
        step = step if step is not None else self._last_step
        means = {k: sum(v) / len(v) for k, v in self._pending.items() if v}
        self._pending.clear()
        record = {"step": int(step), "time": time.time() - self._t0, **means}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        for k, v in means.items():
            self._history[k].append((step, v))
        if not self.quiet:
            parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items()))
            print(f"step {step}: {parts}", flush=True)
        if self.plot:
            self._render()
        return means

    def _render(self) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            self.plot = False
            return
        for k, pairs in self._history.items():
            if len(pairs) < 2:
                continue
            xs, ys = zip(*pairs)
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.plot(xs, ys)
            ax.set_xlabel("step")
            ax.set_ylabel(k)
            fig.tight_layout()
            fig.savefig(os.path.join(self.workdir, f"{k}.jpg"))
            plt.close(fig)
