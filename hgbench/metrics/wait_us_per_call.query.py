"""wait_us_per_call.query: the host's time in the query's result copy
(``query.result``: the two blocking device-to-host copies of the distances
and indices, which wait for the device to finish the call, into pageable
memory), in microseconds a call, from the program's spans in the traced
window."""

from hgbench import program_spans


def read(run):
    snap = program_spans.snapshot()
    t = program_spans.total_ns(snap, "query.result")
    return None if t is None else program_spans.per_count(
        t, "query.calls", 1e3, snap)
