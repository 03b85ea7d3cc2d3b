"""mfu.train: the whole step's share of the card's bf16 peak (989 TFLOP/s
dense), in %: the FLOPs of the benchmark's own plain reference step at
the cell's shapes (matmuls and convolutions, forward and backward, as
``torch.utils.flop_counter`` counts them on the meta device), times the
steps taken in the traced window, over the window."""

from hgbench import stats


def read(run):
    c = run.counters
    if run.trace is None or not c.get("steps") or not c.get("flops_per_step"):
        return None
    return (100.0 * c["flops_per_step"] * c["steps"]
            / stats.BF16_FLOPS_PER_S / run.trace.window_s)
