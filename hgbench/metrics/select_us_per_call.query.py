"""select_us_per_call.query: the host's time in the scan's selects
(``scan.select``: the winner columns' two-level top-k over the scan's
keys; ``scan.merge``: the final top-k over the rescan's keys and their
decode), in microseconds a call, from the program's spans in the traced
window."""

from hgbench import program_spans


def read(run):
    snap = program_spans.snapshot()
    t = program_spans.total_ns(snap, "scan.select", "scan.merge")
    return None if t is None else program_spans.per_count(
        t, "query.calls", 1e3, snap)
