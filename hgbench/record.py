"""What one run leaves for the metric readers and the result line."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from hgbench.core import Cell
from hgbench.tracing import TraceSummary


@dataclasses.dataclass
class RunRecord:
    cell: Cell
    seed: int
    seconds: float
    device: str
    setup_s: Optional[float] = None
    window_s: Optional[float] = None          # the timed window, host clock
    attempted: int = 0
    failed: int = 0
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    trace: Optional[TraceSummary] = None
    # name -> (number compared, its limit); a run is correct when every
    # number is at or under its limit
    checks: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)

    def note(self, line: str) -> None:
        """A line printed before the result (what a reader should know of
        the run: lateness, the north star, the card)."""
        self.notes.append(line)
