"""The share of the traced window in which nothing ran on the device
(1 - the union of its kernels, copies and fills over the window), in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.trace.idle_share
