"""Tracing (port of ``hashgan_tpu/utils/profiling.py``) and the program's
spans, phases and counters.

- ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  with CPU activity and, where CUDA is available, CUDA activity; on exit it
  writes a Chrome/Perfetto trace (``chrome://tracing``, ui.perfetto.dev)
  into ``logdir``. While it records, the spans below are on.
- ``span(name, id=None)``: a context manager around one piece of the hot
  path (a query's stage, a training step's phase). It is off while no
  ``torch.profiler`` records: it then reads one flag and returns one shared
  object that does nothing, with no allocation and no clock read. On, it
  opens the range ``torch.profiler.record_function(name)`` opens (a
  ``user_annotation``, with the id as its argument), so the span lies in
  the device trace's timeline on its clock, and keeps in memory its
  name, ``time.perf_counter_ns`` start and end, its parent and its id: a
  top-level span's id (a query call's number, a training step) is given,
  a child span inherits its parent's. Each span adds its duration to its
  parent's child time, so self time is duration minus the children's.
- ``phase(name)``: once-per-run set-up work, always timed into the same
  recorder, and the same range while a profiler records.
- ``count(name, n=1)``: a counter, on and off as the spans are.
- ``snapshot()``: per span name the count, total and self ns, with the
  counters and the phases; ``records()``: the spans kept, oldest first;
  ``reset()`` clears all of them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

_traces = itertools.count()
# the profiler's own flag: true while any torch.profiler records
_profiler_enabled = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns
# The user-scope range that torch.profiler.record_function opens, through
# its C binding: a quarter of record_function's cost a span (its Python
# wrapper dispatches two torch.ops calls), the same user_annotation.
_open_range = torch._C._autograd._record_function_with_args_enter
_close_range = torch._C._autograd._record_function_with_args_exit
MAX_RECORDS = 1 << 18  # spans kept in memory; the totals count them all


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profiles the block, with the program's spans on; yields the profiler
    (``key_averages()`` and the rest of its API). On exit the trace is
    written to ``<logdir>/trace_<pid>_<n>.json`` (default ``logdir``: a
    folder under the temporary directory), and the profiler's
    ``trace_path`` names it. The spans appear in it as ``user_annotation``
    ranges; ``snapshot()`` sums them."""
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


class SpanRecord(NamedTuple):
    seq: int                  # the span's number, in the order spans opened
    name: str
    start_ns: int             # time.perf_counter_ns
    end_ns: int
    parent: Optional[int]     # the parent's seq; None at the top level
    id: Optional[int]         # the top-level span's id


class _Off:
    """The span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "seq", "child_ns", "start",
                 "range", "stack")

    def __init__(self, rec: "Recorder", name: str, id: Optional[int]):
        self.rec, self.name, self.id = rec, name, id
        self.child_ns = 0

    def __enter__(self):
        stack = self.rec._stack()
        parent = stack[-1] if stack else None
        if self.id is None and parent is not None:
            self.id = parent.id
        self.parent, self.stack = parent, stack
        self.seq = next(self.rec._seq)
        self.range = (_open_range(self.name) if self.id is None
                      else _open_range(self.name, self.id))
        stack.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        self.stack.pop()
        self.rec._close(self, end)
        _close_range(self.range)
        return False


class Recorder:
    """Spans, phases and counters of one process (module doc)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._spans: Dict[str, List[int]] = {}  # count, total, self
            self._phases: Dict[str, List[int]] = {}  # count, total
            self._counters: Dict[str, int] = {}
            self._records: collections.deque = collections.deque(
                maxlen=MAX_RECORDS)
            self._seq = itertools.count()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, id: Optional[int] = None):
        if not _profiler_enabled():
            return _OFF
        return _Span(self, name, id)

    def _close(self, s: _Span, end: int) -> None:
        dur = end - s.start
        parent = s.parent
        if parent is not None:
            parent.child_ns += dur
        with self._lock:
            agg = self._spans.get(s.name)
            if agg is None:
                agg = self._spans[s.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - s.child_ns
            self._records.append(SpanRecord(
                s.seq, s.name, s.start, end,
                None if parent is None else parent.seq, s.id))

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        rng = _open_range(name) if _profiler_enabled() else None
        start = _clock()
        try:
            yield
        finally:
            dur = _clock() - start
            if rng is not None:
                _close_range(rng)
            with self._lock:
                agg = self._phases.setdefault(name, [0, 0])
                agg[0] += 1
                agg[1] += dur

    def count(self, name: str, n: int = 1) -> None:
        if not _profiler_enabled():
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def snapshot(self) -> dict:
        """{"spans": {name: {"count", "total_ns", "self_ns"}}, "counters":
        {name: n}, "phases": {name: {"count", "total_ns"}}}."""
        with self._lock:
            return {
                "spans": {k: {"count": c, "total_ns": t, "self_ns": s}
                          for k, (c, t, s) in self._spans.items()},
                "counters": dict(self._counters),
                "phases": {k: {"count": c, "total_ns": t}
                           for k, (c, t) in self._phases.items()},
            }

    def records(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._records)


_RECORDER = Recorder()
span = _RECORDER.span
phase = _RECORDER.phase
count = _RECORDER.count
snapshot = _RECORDER.snapshot
records = _RECORDER.records
reset = _RECORDER.reset
