"""k2_roofline.scan: the full-key scan kernel (K2,
``csrc/mxu_fullkey_scan.cu``) against its roofline, in %.

The least time of the scan's work is its operations, 2 Q N B for Q query
rows against the gallery's N true items of B bits, at the int8 tensor-core
peak, or its bytes (the packed gallery and queries read once a launch) at
the memory rate, whichever is larger; the operations bound it by about 20x.
The time is the kernel's summed time in the traced window."""

from hgbench import stats

KERNEL = "fullkey_scan_s8_kernel"


def read(run):
    if run.trace is None or not run.counters.get("rows_answered"):
        return None
    launches, seconds = run.trace.kernel_time(KERNEL)
    if not launches:
        return None
    c = run.counters
    n, bits, rows = c["n_items"], c["bits"], c["rows_answered"]
    ops = 2.0 * rows * n * bits
    bytes_moved = launches * n * bits / 8 + rows * bits / 8
    return stats.roofline_pct(ops, stats.INT8_OPS_PER_S, bytes_moved, seconds)
