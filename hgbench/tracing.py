"""The traced run: ``torch.profiler`` over the window, reduced to what the
metrics read.

The window is a ``record_function`` span (``WINDOW``) that the drivers put
around their timed loop. From the Chrome trace the profiler exports, the
reduction keeps, clipped to that span: the device's activity (kernels,
copies, fills) as a union of intervals (``busy_s``), its time by name, and
its idle gaps, each named by what the host was doing in its middle (the
innermost host event that covers it, else the last one that ended before
it). The trace file is written under the temporary directory and deleted.
"""

from __future__ import annotations

import bisect
import collections
import heapq
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "hgbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
MAX_NAMED_GAPS = 100_000  # the longest gaps are named; the rest are summed


class TraceSummary:
    """What one traced window holds, in seconds."""

    def __init__(self, window_s: float, intervals: List[Tuple[float, float]],
                 device_by_name: Dict[str, float],
                 gaps_by_host: Dict[str, float],
                 kernels: Dict[str, Tuple[int, float]]):
        self.window_s = window_s
        self.busy_s = sum(e - s for s, e in intervals)  # merged activity
        self.device_by_name = device_by_name
        self.gaps_by_host = gaps_by_host
        self.kernels = kernels              # name -> (launches, seconds)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_time(self, fragment: str) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds
        ``fragment``."""
        n, t = 0, 0.0
        for name, (count, secs) in self.kernels.items():
            if fragment in name:
                n += count
                t += secs
        return n, t

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    [:top]]
        return {"device_ops": head(self.device_by_name),
                "idle_gaps": head(self.gaps_by_host)}


class Tracer:
    """``with Tracer() as t: ...``; ``t.summary`` after the block."""

    def __init__(self):
        self.summary: Optional[TraceSummary] = None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(prefix="hgbench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        self.summary = summarize(events)
        return False


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(events: List[dict]) -> TraceSummary:
    """Reduce Chrome trace events (microseconds) to a ``TraceSummary`` of
    the ``WINDOW`` span. Raises where the trace has no window."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in complete if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    device, by_name = [], collections.defaultdict(float)
    kernels: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    for e in complete:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        device.append((s, t))
        by_name[e["name"]] += (t - s) * 1e-6
        if e.get("cat") == "kernel":
            k = kernels[e["name"]]
            k[0] += 1
            k[1] += (t - s) * 1e-6
    merged = _merge(device)
    gaps, prev = [], w0
    for s, t in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in complete if e.get("cat") in HOST_CATS
                  and e.get("name") != WINDOW)
    gaps_by_host = _name_gaps(gaps, host)
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6,
        intervals=[(s * 1e-6, t * 1e-6) for s, t in merged],
        device_by_name=dict(by_name), gaps_by_host=gaps_by_host,
        kernels={k: (int(v[0]), v[1]) for k, v in kernels.items()})


def _name_gaps(gaps: List[Tuple[float, float]],
               host: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Idle seconds by what the host was doing: ``in <event>`` for the
    innermost host event covering a gap's middle, else ``after <event>``
    for the last one that ended before it. The longest ``MAX_NAMED_GAPS``
    gaps are named; the rest are summed under ``(shorter gaps)``."""
    out: Dict[str, float] = collections.defaultdict(float)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    for s, t in gaps[MAX_NAMED_GAPS:]:
        out["(shorter gaps)"] += (t - s) * 1e-6
    named = sorted(gaps[:MAX_NAMED_GAPS], key=lambda g: g[0] + g[1])
    starts = [h[0] for h in host]
    ends_sorted = sorted((h[1], h[2]) for h in host)
    end_keys = [e for e, _ in ends_sorted]
    active: list = []
    i = 0
    for s, t in named:
        mid = 0.5 * (s + t)
        while i < len(host) and starts[i] <= mid:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        if active:
            label = "in " + active[0][2]
        else:
            j = bisect.bisect_right(end_keys, mid) - 1
            label = ("after " + ends_sorted[j][1]) if j >= 0 else "(no host event)"
        out[label] += (t - s) * 1e-6
    return dict(out)
