"""data_setup_s.train: the seconds ``Experiment`` spent making its data
splits in set-up (the program's phase ``setup.splits``: the train, query
and database images it draws)."""

from hgbench import program_spans


def read(run):
    phases = (program_spans.snapshot() or {}).get("phases", {})
    if "setup.splits" not in phases:
        return None
    return phases["setup.splits"]["total_ns"] / 1e9
