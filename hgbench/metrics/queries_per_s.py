"""queries_per_s: query rows answered over the whole window, divided by the
window (host clock, from the first call to the return of the last)."""

from hgbench import stats


def read(run):
    if "rows_answered" not in run.counters:
        return None
    return stats.rate(run.counters["rows_answered"], run.window_s)
