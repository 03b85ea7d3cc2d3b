"""setup_s: seconds from the harness's first line to the first timed
operation (loading, building, warming up; a checkout's first run also
compiles the kernels)."""


def read(run):
    return run.setup_s
