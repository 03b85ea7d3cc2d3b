"""Tracing and timing helpers (port of ``hashgan_tpu/utils/profiling.py``).

- ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  with CPU activity and, where CUDA is available, CUDA activity; on exit it
  writes a Chrome/Perfetto trace (``chrome://tracing``, ui.perfetto.dev)
  into ``logdir``.
- ``time_fn``: best-of wall-clock seconds, synchronised on the device of
  the result (``torch.cuda.synchronize`` of that device for a CUDA result).
- ``kernel_throughput``: ``time_fn`` with the achieved bytes/s and ops/s.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import time
from typing import Callable, Dict, Iterator, Optional

import torch

_traces = itertools.count()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profiles the block; yields the profiler (``key_averages()`` and the
    rest of its API). On exit the trace is written to
    ``<logdir>/trace_<pid>_<n>.json`` (default ``logdir``: a folder under the
    temporary directory), and the profiler's ``trace_path`` names it."""
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "hashgan_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
    prof.trace_path = os.path.join(
        logdir, f"trace_{os.getpid()}_{next(_traces)}.json")
    prof.export_chrome_trace(prof.trace_path)


def _first_tensor(out) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for leaf in out:
            found = _first_tensor(leaf)
            if found is not None:
                return found
    return None


def _sync(out) -> None:
    """Waits for the device of the result's first tensor (a host result
    is ready when it is returned)."""
    leaf = _first_tensor(out)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1,
            **kwargs) -> float:
    """Best-of-``iters`` wall-clock seconds of ``fn(*args, **kwargs)``,
    device-synced, after ``warmup`` calls."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best


def kernel_throughput(fn: Callable, *args,
                      bytes_accessed: Optional[int] = None,
                      ops: Optional[int] = None, iters: int = 5,
                      **kwargs) -> Dict[str, float]:
    """``seconds`` of ``time_fn`` and, where given the work, the achieved
    ``gbytes_per_sec`` and ``gops_per_sec``."""
    dt = time_fn(fn, *args, iters=iters, **kwargs)
    out: Dict[str, float] = {"seconds": dt}
    if bytes_accessed:
        out["gbytes_per_sec"] = bytes_accessed / dt / 1e9
    if ops:
        out["gops_per_sec"] = ops / dt / 1e9
    return out
