"""mfu.scan: the whole call's share of the card's int8 peak, in %: the
scan's operations, 2 Q N B for every query row answered in the traced
window (N the gallery's true items, B bits), over the window, at 1,979
TOP/s."""

from hgbench import stats


def read(run):
    if run.trace is None or not run.counters.get("rows_answered"):
        return None
    c = run.counters
    ops = 2.0 * c["rows_answered"] * c["n_items"] * c["bits"]
    return 100.0 * ops / stats.INT8_OPS_PER_S / run.trace.window_s
