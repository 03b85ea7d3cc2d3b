"""The program's own spans, phases and counters, as the ``program_span``
metrics read them.

The program keeps them in memory (``hashgan_tpu_torch.utils.profiling``):
its spans and counters only while a ``torch.profiler`` records, which in a
run is the traced window alone, and its set-up phases always. A program
without them (an older commit) gives None, and so does each reader.
"""

from __future__ import annotations

from typing import Optional


def snapshot() -> Optional[dict]:
    """``profiling.snapshot()``, or None where the program has none."""
    try:
        from hashgan_tpu_torch.utils.profiling import snapshot as program
    except ImportError:
        return None
    return program()


def per_count(total_ns: float, counter: str, unit_ns: float,
              snap: Optional[dict]) -> Optional[float]:
    """``total_ns`` over the program's ``counter``, in units of
    ``unit_ns``; None where the counter is absent or 0."""
    n = (snap or {}).get("counters", {}).get(counter)
    if not n:
        return None
    return total_ns / unit_ns / n


def total_ns(snap: Optional[dict], *names: str) -> Optional[float]:
    """The summed total time of the spans ``names``; None where any of
    them is absent."""
    spans = (snap or {}).get("spans", {})
    if not all(n in spans for n in names):
        return None
    return float(sum(spans[n]["total_ns"] for n in names))


def self_ns_ending(snap: Optional[dict], suffix: str) -> Optional[float]:
    """The summed self time of every span whose name ends in ``suffix``
    (a span nested in another of its kind counts once); None where there
    is none."""
    spans = [s for name, s in (snap or {}).get("spans", {}).items()
             if name.endswith(suffix)]
    if not spans:
        return None
    return float(sum(s["self_ns"] for s in spans))
