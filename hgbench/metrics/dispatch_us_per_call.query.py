"""dispatch_us_per_call.query: the host's time in a query call outside its
result copy (the span ``query`` less ``query.result``: the host-to-device
copy, the pack, the scan's launches and selects, the merge), in
microseconds a call, from the program's spans in the traced window."""

from hgbench import program_spans


def read(run):
    snap = program_spans.snapshot()
    whole = program_spans.total_ns(snap, "query")
    wait = program_spans.total_ns(snap, "query.result")
    if whole is None or wait is None:
        return None
    return program_spans.per_count(whole - wait, "query.calls", 1e3, snap)
