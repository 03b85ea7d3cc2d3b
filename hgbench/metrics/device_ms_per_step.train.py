"""device_ms_per_step.train: the device's busy time in the traced window
(the union of its kernels, copies and fills) over the training cycles or
steps taken in it."""


def read(run):
    if run.trace is None or not run.counters.get("steps"):
        return None
    return run.trace.busy_s * 1e3 / run.counters["steps"]
